"""Relative-pose drift metrics for video tracks.

Functional equivalents of the reference's pinocchio-based metrics
(src/utils/video_evaluation.py:4-140): rotation / projection / depth drift
over frame gaps dt, with 1-axis symmetry sweep and object-origin alignment.
Host-side eval code (tracks are tiny), vectorized numpy over all frame pairs
and symmetry samples at once instead of the reference's per-pair Python loops.

A copy of freepose_tpu.evaluation.video_metrics (numpy and scipy):
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as Rot


def _log_so3(rots: np.ndarray) -> np.ndarray:
    """[N, 3, 3] -> [N, 3] rotation vectors."""
    return Rot.from_matrix(rots).as_rotvec()


def rot_errors(
    est_r: np.ndarray,  # [N, 3, 3]
    gt_r: np.ndarray,  # [N, 3, 3]
    dt: int,
    sym_axis: np.ndarray | None = None,
    n_symmetries: int = 101,
) -> np.ndarray:
    """Camera-frame relative-rotation error per pair (t, t+dt), with min over
    a 1-axis symmetry sweep (reference video_evaluation.py:37-63)."""
    n = len(est_r)
    if n - dt <= 0:
        return np.zeros(0)
    r1e, r2e = est_r[: n - dt], est_r[dt:]
    r1g, r2g = gt_r[: n - dt], gt_r[dt:]
    a = _log_so3(np.einsum("nij,nkj->nik", r2e, r1e))  # log(R2e R1e^T), [M, 3]

    if sym_axis is None:
        syms = np.eye(3)[None]
    else:
        angles = np.linspace(-np.pi, np.pi, n_symmetries)
        syms = Rot.from_rotvec(np.asarray(sym_axis)[None] * angles[:, None]).as_matrix()

    errs = np.empty((len(syms), n - dt))
    for si, s in enumerate(syms):
        b = _log_so3(np.einsum("nij,jk,nlk->nil", r2g, s, r1g))  # log(R2g S R1g^T)
        errs[si] = np.linalg.norm(a - b, axis=-1)
    return errs.min(axis=0)


def average_rot_errors_dt(est_r, gt_r, dts, sym_axis=None, n_symmetries=101) -> float:
    vals = [np.mean(rot_errors(est_r, gt_r, int(dt), sym_axis, n_symmetries)) / dt for dt in dts]
    return float(np.mean(vals))


def project_translation(t: np.ndarray, w: int, h: int, k: np.ndarray | None = None) -> np.ndarray:
    """[..., 3] translations -> [..., 2] pixels; synthetic K = diag-focal if
    none given (reference video_evaluation.py:100-109)."""
    if k is None:
        f = np.sqrt(w**2 + h**2)
        k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    uvw = t @ k.T
    return uvw[..., :2] / uvw[..., 2:]


def align_object_origins(
    est_r: np.ndarray, est_t: np.ndarray, gt_t: np.ndarray, scale: float
) -> np.ndarray:
    """Shift the estimated track's object origin so its projection rays match
    GT (needed when retrieved mesh != GT mesh; reference
    video_evaluation.py:112-140). Returns adjusted est translations."""
    norms_gt = np.linalg.norm(gt_t, axis=-1, keepdims=True)
    norms_est = np.linalg.norm(est_t, axis=-1, keepdims=True)
    x = gt_t / np.maximum(norms_gt, 1e-12) * norms_est  # gt direction, est depth
    # origin in object-1 frame: R^T (x - t)
    origin_in_o1 = np.einsum("nji,nj->ni", est_r, x - est_t)
    keep = np.linalg.norm(origin_in_o1, axis=-1) < scale
    if not keep.any():
        return est_t
    origin = origin_in_o1[keep].mean(axis=0)
    norm = np.linalg.norm(origin)
    max_change = scale / 2.0
    if norm > max_change:
        origin = origin / norm * max_change
    # p * T with T = (I, origin): t' = R @ origin + t
    return np.einsum("nij,j->ni", est_r, origin) + est_t


def depth_errors(est_t, gt_t, est_scale, gt_scale, dt) -> np.ndarray:
    n = len(est_t)
    v_est = (np.linalg.norm(est_t[: n - dt], axis=-1) - np.linalg.norm(est_t[dt:], axis=-1)) / est_scale
    v_gt = (np.linalg.norm(gt_t[: n - dt], axis=-1) - np.linalg.norm(gt_t[dt:], axis=-1)) / gt_scale
    return np.abs(v_est - v_gt)


def average_depth_errors_dt(est_r, est_t, gt_t, est_scale, gt_scale, dts) -> float:
    est_t_new = align_object_origins(est_r, est_t, gt_t, est_scale)
    vals = [np.mean(depth_errors(est_t_new, gt_t, est_scale, gt_scale, int(dt))) / dt for dt in dts]
    return float(np.mean(vals))


def proj_errors(est_t, gt_t, dt, w, h, k=None) -> np.ndarray:
    n = len(est_t)
    p_est = project_translation(est_t, w, h, k)
    p_gt = project_translation(gt_t, w, h, k)
    v_est = p_est[dt:] - p_est[: n - dt]
    v_gt = p_gt[dt:] - p_gt[: n - dt]
    return np.linalg.norm(v_est - v_gt, axis=-1)


def average_proj_errors_dt(est_r, est_t, gt_t, est_scale, dts, w, h, k=None) -> float:
    diag = np.sqrt(w**2 + h**2)
    est_t_new = align_object_origins(est_r, est_t, gt_t, est_scale)
    vals = [np.mean(proj_errors(est_t_new, gt_t, int(dt), w, h, k)) / dt for dt in dts]
    return float(np.mean(vals)) / diag * 100.0


def default_dts(n_frames: int, n_dts: int = 10) -> np.ndarray:
    """dt grid = linspace(1, N/2, 10) (reference eval_videos.py:186)."""
    return np.unique(np.linspace(1, max(n_frames // 2, 1), n_dts).astype(int))
