"""BOP pose-error functions on tensors, PyTorch.

Counterpart of freepose_tpu.evaluation.pose_error: the vendored bop_toolkit
error set (bop_toolkit/bop_toolkit_lib/pose_error.py): vsd, cus, mssd, mspd,
add, adi, re, te, proj, cou_bb, cou_mask, cou_bb_proj, plus the repo's
retrieval-aware chamfer / chamfer_proj (retrieved meshes differ from GT
meshes). Every function takes array-likes (numpy or tensors), computes in
float32 on `device` ("cuda" unless the caller asks for the CPU) and returns
Python floats; `re` and `te` stay float64 numpy on the host, as in JAX.

Chamfer nearest neighbours are an exact pairwise-distance min-reduction by
the expansion trick x² + y² − 2·x·yᵀ (the product through torch.matmul, as
the JAX package leaves it to XLA), clamped at 0, then sqrt; in float32 with
TF32 off (the CLIs call scripts/common.py:full_fp32). The [N, M] transient
is cut into blocks of CHAMFER_ROWS rows, so a pair of 8,192-point sets holds
67 MB at a time instead of 268 MB; the mins and means are the same either
way (a min is order-free, each row's sum is unchanged). The trick cancels:
at pixel scale (chamfer_proj, coordinates ~300 px) one ulp of a projected
point moves a distance of a few pixels by ~1e-3 of itself, so where the
JAX package's eager 3x3 products round otherwise than torch.matmul the two
agree to ~1e-5 relative, not to the last bit.

`MaskRenderer` renders depth for `cus`, `vsd` and `cou_bb_proj`, one pose
per call: backend "device" through ops/rasterizer.py:rasterize (kernel K1
on a CUDA device, the plain rasterizer on the CPU), "native" through the
C++ host rasterizer (ops/raster_native.py), "auto" = "device" on a CUDA
device, "native" on the CPU, as the JAX package picks on a host with no
accelerator. A native build that fails raises.
"""
from __future__ import annotations

import numpy as np
import torch

from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize

CHAMFER_ROWS = 2048


def _t(x, device) -> torch.Tensor:
    """An array-like as a float32 tensor on `device` (float64 inputs round
    to float32 once, as jnp.asarray does without x64)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Σ_k x_k² over the last dim. On the CPU rounded as XLA's fused
    reduction on the CPU rounds it, fma(x_k, x_k, … fma(x_1, x_1, x_0·x_0)):
    each fma one float64 multiply and add (the product is exact) rounded once
    to float32. Distances near 0 come out of the expansion trick by
    cancellation, so this keeps the CPU's results equal to the JAX
    package's, which its tests compare; on other devices plain float32."""
    if x.device.type != "cpu":
        return x.pow(2).sum(-1)
    acc = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        xi = x[..., i].double()
        acc = (xi * xi + acc.double()).to(torch.float32)
    return acc


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Float32 sqrt. On the CPU correctly rounded (through float64), as
    XLA's is: PyTorch's vectorised CPU sqrt is not, in ~0.7% of values."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(torch.float32)


def _norms(x: torch.Tensor) -> torch.Tensor:
    return _sqrt(_sq_norms(x))


def transform_pts(pts: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """pts [..., N, 3] -> R·p + t; r [..., 3, 3] and t [..., 3] batch over
    leading dims."""
    return pts @ r.transpose(-1, -2) + t.reshape(*t.shape[:-1], 1, 3)


def project_pts(pts: torch.Tensor, k: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    cam = transform_pts(pts, r, t)
    uvw = cam @ k.transpose(-1, -2)
    return uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-9)


def _nn_sq_dists(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared distance from each point of x [N, 3] to its nearest point of
    y [M, 3], and from each point of y to its nearest of x: ([N], [M]), over
    blocks of CHAMFER_ROWS rows of x."""
    y2 = _sq_norms(y)[None, :]
    x_min, y_min = [], torch.full((y.shape[0],), float("inf"), device=y.device)
    for i in range(0, x.shape[0], CHAMFER_ROWS):
        xb = x[i : i + CHAMFER_ROWS]
        x2 = _sq_norms(xb)[:, None]
        d2 = torch.clamp(x2 + y2 - 2.0 * (xb @ y.T), min=0.0)
        x_min.append(d2.amin(dim=1))
        y_min = torch.minimum(y_min, d2.amin(dim=0))
    return torch.cat(x_min), y_min


def _chamfer_bi(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bidirectional chamfer: mean min ||x_i - y_j|| both ways (reference
    chamfer_distance with direction='bi', metric=l2)."""
    x_min, y_min = _nn_sq_dists(x, y)
    # sqrt is monotone, so the min of the distances is the sqrt of the min.
    return _sqrt(x_min).mean() + _sqrt(y_min).mean()


def chamfer(r_est, t_est, r_gt, t_gt, pts_est, pts_gt, device=None) -> float:
    dev = resolve_device(device)
    a = transform_pts(_t(pts_est, dev), _t(r_est, dev), _t(t_est, dev).reshape(3))
    b = transform_pts(_t(pts_gt, dev), _t(r_gt, dev), _t(t_gt, dev).reshape(3))
    return float(_chamfer_bi(a, b))


def chamfer_proj(r_est, t_est, r_gt, t_gt, k, pts_est, pts_gt, device=None) -> float:
    dev = resolve_device(device)
    kk = _t(k, dev)
    a = project_pts(_t(pts_est, dev), kk, _t(r_est, dev), _t(t_est, dev).reshape(3))
    b = project_pts(_t(pts_gt, dev), kk, _t(r_gt, dev), _t(t_gt, dev).reshape(3))
    return float(_chamfer_bi(a, b))


def add(r_est, t_est, r_gt, t_gt, pts, device=None) -> float:
    dev = resolve_device(device)
    p = _t(pts, dev)
    a = transform_pts(p, _t(r_est, dev), _t(t_est, dev).reshape(3))
    b = transform_pts(p, _t(r_gt, dev), _t(t_gt, dev).reshape(3))
    return float(_norms(a - b).mean())


def adi(r_est, t_est, r_gt, t_gt, pts, device=None) -> float:
    """Average distance to the nearest GT-pose point (indistinguishable
    views)."""
    dev = resolve_device(device)
    p = _t(pts, dev)
    a = transform_pts(p, _t(r_est, dev), _t(t_est, dev).reshape(3))
    b = transform_pts(p, _t(r_gt, dev), _t(t_gt, dev).reshape(3))
    return float(_sqrt(_nn_sq_dists(a, b)[0]).mean())


def re(r_est, r_gt) -> float:
    """Rotation error (deg)."""
    cos = (np.trace(np.asarray(r_est) @ np.asarray(r_gt).T) - 1.0) / 2.0
    return float(np.rad2deg(np.arccos(np.clip(cos, -1.0, 1.0))))


def te(t_est, t_gt) -> float:
    return float(np.linalg.norm(np.asarray(t_est).reshape(3) - np.asarray(t_gt).reshape(3)))


def proj(r_est, t_est, r_gt, t_gt, k, pts, device=None) -> float:
    """Average projection distance."""
    dev = resolve_device(device)
    p, kk = _t(pts, dev), _t(k, dev)
    a = project_pts(p, kk, _t(r_est, dev), _t(t_est, dev).reshape(3))
    b = project_pts(p, kk, _t(r_gt, dev), _t(t_gt, dev).reshape(3))
    return float(_norms(a - b).mean())


def _sym_poses(r_gt, t_gt, syms):
    rs, ts = [], []
    for s in syms or [{"R": np.eye(3), "t": np.zeros(3)}]:
        rs.append(np.asarray(r_gt) @ np.asarray(s["R"]))
        ts.append(np.asarray(r_gt) @ np.asarray(s["t"]).reshape(3) + np.asarray(t_gt).reshape(3))
    return np.stack(rs), np.stack(ts)


def mssd(r_est, t_est, r_gt, t_gt, pts_est, pts_gt, syms=None, device=None) -> float:
    """Maximum symmetry-aware surface distance: the least over the GT's
    symmetric poses of the largest point distance. When the estimate and GT
    use different meshes the max over corresponding indices is undefined;
    like the reference this assumes pts_est == pts_gt."""
    dev = resolve_device(device)
    rs, ts = _sym_poses(r_gt, t_gt, syms)
    a = transform_pts(_t(pts_est, dev), _t(r_est, dev), _t(t_est, dev).reshape(3))
    b = transform_pts(_t(pts_gt, dev), _t(rs, dev), _t(ts, dev))  # [S, N, 3]
    return float(_norms(a - b).amax(dim=-1).amin())


def mspd(r_est, t_est, r_gt, t_gt, k, pts_est, pts_gt, syms=None, device=None) -> float:
    dev = resolve_device(device)
    rs, ts = _sym_poses(r_gt, t_gt, syms)
    kk = _t(k, dev)
    a = project_pts(_t(pts_est, dev), kk, _t(r_est, dev), _t(t_est, dev).reshape(3))
    b = project_pts(_t(pts_gt, dev), kk, _t(rs, dev), _t(ts, dev))  # [S, N, 2]
    return float(_norms(a - b).amax(dim=-1).amin())


def cou_bb(bb_est, bb_gt, device=None) -> float:
    """Complement over union of xywh boxes."""
    from freepose_tpu_torch.geometry.boxes import bbox_iou

    dev = resolve_device(device)
    return 1.0 - float(bbox_iou(_t(bb_est, dev), _t(bb_gt, dev)))


def _bool_mask(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.bool)


def cou_mask(mask_est, mask_gt, device=None) -> float:
    """Complement over union of 2D binary masks (reference
    pose_error.py:336-355)."""
    dev = resolve_device(device)
    mask_est, mask_gt = _bool_mask(mask_est, dev), _bool_mask(mask_gt, dev)
    union = int((mask_est | mask_gt).sum())
    if union == 0:
        return 1.0
    return 1.0 - int((mask_est & mask_gt).sum()) / float(union)


def _mask_xywh(mask: torch.Tensor) -> torch.Tensor | None:
    """Bounding box (x, y, w, h) float32 of a [H, W] bool mask; None when it
    is empty. w and h are max − min, as the reference's xywh."""
    from freepose_tpu_torch.geometry.boxes import mask_to_bbox

    if not bool(mask.any()):
        return None
    x0, y0, x1, y1 = mask_to_bbox(mask).to(torch.float32)
    return torch.stack([x0, y0, x1 - x0, y1 - y0])


def cou_bb_proj(r_est, t_est, r_gt, t_gt, k, renderer: "MaskRenderer", obj_id) -> float:
    """Complement over union of the projected silhouettes' bounding boxes
    (reference pose_error.py:400-428). Empty renders score 1.0 (the
    reference would raise on an empty mask; defensive-skip parity)."""
    bb_est = _mask_xywh(renderer.render_depth(obj_id, r_est, t_est, k) > 0)
    bb_gt = _mask_xywh(renderer.render_depth(obj_id, r_gt, t_gt, k) > 0)
    if bb_est is None or bb_gt is None:
        return 1.0
    return cou_bb(bb_est, bb_gt, device=renderer.device)


class MaskRenderer:
    """Depth renderer for `cus`/`vsd`/`cou_bb_proj`, replacing the eval-side
    GL renderers (reference renderer_vispy.py / renderer_cpp.py), on
    `device` ("cuda" unless the caller asks for the CPU).

    "device" renders padded meshes (`pad_mesh` to max_vertices and
    max_faces) through ops/rasterizer.py:rasterize at resolution max(w, h),
    cropped to [:h, :w], tile 37 when that resolution divides by 37, else 32,
    `max_faces_per_tile` faces per tile, depth only: on a CUDA device
    kernel K1, on the CPU the plain rasterizer. "native" renders the
    unpadded mesh with the C++ host rasterizer at h x w. "auto" picks
    "device" on a CUDA device and "native" on the CPU.

    Conventions (pinned by tests/test_torch_pose_error.py against an
    analytic silhouette oracle): a camera point X maps to image coordinates
    (fx·X/Z + cx, fy·Y/Z + cy); pixel (i, j) is lit iff the projected
    triangle covers the PIXEL CENTRE (i + 0.5, j + 0.5); the viewport origin
    is the top-left corner of pixel (0, 0), as the reference GL path samples
    coverage (renderer_vispy.py:26-110)."""

    def __init__(self, width: int, height: int, max_vertices: int = 8192,
                 max_faces: int = 16384, backend: str = "auto",
                 max_faces_per_tile: int = 256, device=None):
        self.device = resolve_device(device)
        self.size = max(width, height)
        self.width = width
        self.height = height
        # max_faces_per_tile bounds the per-tile candidate list (faces whose
        # bbox overlaps a tile beyond it are dropped): raise it for meshes
        # much denser than the render resolution.
        self.settings = RasterSettings(
            resolution=self.size, tile=37 if self.size % 37 == 0 else 32,
            max_faces_per_tile=max_faces_per_tile, depth_only=True,
        )
        self.max_vertices = max_vertices
        self.max_faces = max_faces
        if backend == "auto":
            backend = "device" if self.device.type == "cuda" else "native"
        if backend not in ("device", "native"):
            raise ValueError(f"unknown MaskRenderer backend {backend!r}")
        self.backend = backend
        self._meshes: dict = {}

    def add_object(self, obj_id, mesh) -> None:
        if self.backend == "native":
            self._meshes[obj_id] = (
                np.asarray(mesh.vertices, np.float32), np.asarray(mesh.faces, np.int32),
            )
            return
        from freepose_tpu_torch.io.mesh import pad_mesh

        v, c, f, valid = pad_mesh(mesh, self.max_vertices, self.max_faces)
        self._meshes[obj_id] = tuple(torch.as_tensor(x, device=self.device) for x in (v, c, f, valid))

    def render_depth(self, obj_id, r, t, k, scale: float = 1.0) -> torch.Tensor:
        """Depth [h, w] float32 on `device`, 0 where nothing is hit. scale
        uniformly scales the object before posing (R(s·v)+t = (sR)v+t,
        folded into the pose's linear part): the reference renderer's
        per-estimate mesh scaling (eval_calc_errors.py:384-385) without
        re-uploading vertices."""
        if self.backend == "native":
            from freepose_tpu_torch.ops import raster_native

            v, f = self._meshes[obj_id]
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.asarray(r, np.float32) * scale
            pose[:3, 3] = np.asarray(t, np.float32).reshape(3)
            _, depth = raster_native.rasterize_native(
                v, f, pose[None], np.asarray(k, np.float32),
                height=self.height, width=self.width,
            )
            return torch.from_numpy(depth[0]).to(self.device)
        v, c, f, valid = self._meshes[obj_id]
        pose = torch.eye(4, device=self.device)
        pose[:3, :3] = _t(r, self.device) * scale
        pose[:3, 3] = _t(t, self.device).reshape(3)
        _, depth = rasterize(v, c, f, valid, pose[None], _t(k, self.device), self.settings)
        return depth[0, : self.height, : self.width]


def depth_im_to_dist_im(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depth (Z) image -> distance-from-camera-centre image (reference
    misc.py:146-165); zeros stay zero."""
    h, w = depth.shape
    xs = (torch.arange(w, dtype=torch.float32, device=depth.device) - k[0, 2]) / k[0, 0]
    ys = (torch.arange(h, dtype=torch.float32, device=depth.device) - k[1, 2]) / k[1, 1]
    scale = torch.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2 + 1.0)
    return depth.to(torch.float32) * scale


def _visib_mask_bop19(d_test: torch.Tensor, d_model: torch.Tensor, delta: float) -> torch.Tensor:
    """bop19 visibility: model surface counts as visible where the scene has
    no depth reading (reference visibility.py:34-39)."""
    d_diff = d_model - d_test
    return ((d_diff <= delta) | (d_test == 0)) & (d_model > 0)


def vsd_errors(depth_test: torch.Tensor, depth_gt: torch.Tensor, depth_est: torch.Tensor, k: torch.Tensor,
               delta: float, diameter: float, taus, cost_type: str,
               normalized_by_diameter: bool) -> torch.Tensor:
    """The VSD error per tau [len(taus)] float32 from three depth images on
    one device: bop19 visibility masks of the GT and estimate against the
    test depth, then the step or tlinear cost summed over their
    intersection (the body of the JAX package's `_vsd_jit`)."""
    dist_test = depth_im_to_dist_im(depth_test, k)
    dist_gt = depth_im_to_dist_im(depth_gt, k)
    dist_est = depth_im_to_dist_im(depth_est, k)

    visib_gt = _visib_mask_bop19(dist_test, dist_gt, delta)
    # Estimated-pose visibility additionally keeps pixels occluded in the
    # estimate but visible in GT (reference visibility.py:60-79, eq. 14).
    visib_est = _visib_mask_bop19(dist_test, dist_est, delta)
    visib_est = visib_est | (visib_gt & (dist_est > 0))

    inter = visib_gt & visib_est
    union_count = (visib_gt | visib_est).sum()
    comp_count = union_count - inter.sum()

    dists = torch.abs(dist_gt - dist_est)
    if normalized_by_diameter:
        dists = dists / diameter

    errors = []
    for tau in taus:
        if cost_type == "step":
            costs = (dists >= tau).to(torch.float32)
        elif cost_type == "tlinear":  # Hodan ECCVW'16
            costs = torch.clamp(dists / tau, max=1.0)
        else:
            raise ValueError(f"unknown VSD cost type {cost_type!r}")
        cost_sum = torch.sum(torch.where(inter, costs, 0.0))
        e = (cost_sum + comp_count) / torch.clamp(union_count, min=1).to(torch.float32)
        errors.append(torch.where(union_count == 0, 1.0, e))
    return torch.stack(errors)


def vsd(
    r_est, t_est, r_gt, t_gt, depth_test, k, delta, taus,
    normalized_by_diameter, diameter, renderer: MaskRenderer, inf_id, gt_id,
    cost_type: str = "step", est_scale: float = 1.0,
) -> list[float]:
    """Visible Surface Discrepancy (reference pose_error.py:17-113): renders
    the estimate's and the GT's depth, estimates bop19 visibility masks
    against the test depth, and scores per misalignment tolerance tau."""
    dev = renderer.device
    depth_est = renderer.render_depth(inf_id, r_est, t_est, k, scale=est_scale)
    depth_gt = renderer.render_depth(gt_id, r_gt, t_gt, k)
    errs = vsd_errors(_t(depth_test, dev), depth_gt, depth_est, _t(k, dev), float(delta), float(diameter),
                      [float(t) for t in taus], cost_type, bool(normalized_by_diameter))
    return [float(e) for e in errs.cpu()]


def cus(r_est, t_est, r_gt, t_gt, k, renderer: MaskRenderer, inf_id, gt_id,
        est_scale: float = 1.0) -> float:
    """Complement over union of rendered silhouettes (reference
    pose_error.py:357-387)."""
    mask_est = renderer.render_depth(inf_id, r_est, t_est, k, scale=est_scale) > 0
    mask_gt = renderer.render_depth(gt_id, r_gt, t_gt, k) > 0
    return cou_mask(mask_est, mask_gt, device=renderer.device)
