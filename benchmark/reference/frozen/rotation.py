"""Rotation utilities: quaternions, SO(3) maps, super-Fibonacci sampling.

Quaternion convention is scalar-last ``[x, y, z, w]`` (scipy's), as in
freepose_tpu.geometry.rotation.
"""
from __future__ import annotations

import numpy as np
import torch

# Magic constants of super-Fibonacci spirals (Alexa, CVPR 2022).
_PHI = 2.0 ** 0.5
_PSI = 1.533751168755204288118041


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] scalar-last quaternion -> [..., 3, 3] rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def super_fibonacci_quats(n: int, device: str | torch.device | None = None) -> torch.Tensor:
    """Super-Fibonacci spiral sampling of SO(3) -> [n, 4] scalar-last quats.

    Computed on the host in float64 (sin/cos of arguments in the thousands of
    radians need double precision), then cast to float32.
    """
    s = np.arange(n, dtype=np.float64) + 0.5
    t = s / n
    r = np.sqrt(t)
    big_r = np.sqrt(1.0 - t)
    alpha = 2.0 * np.pi * s / float(_PHI)
    beta = 2.0 * np.pi * s / _PSI
    q = np.stack(
        [r * np.sin(alpha), r * np.cos(alpha), big_r * np.sin(beta), big_r * np.cos(beta)],
        axis=-1,
    )
    return torch.as_tensor(q.astype(np.float32), device=device)


def super_fibonacci_rotations(n: int, device: str | torch.device | None = None) -> torch.Tensor:
    """[n, 3, 3] rotation matrices of the super-Fibonacci grid."""
    return quat_to_matrix(super_fibonacci_quats(n, device))


def template_poses(n: int, z: float = 1.1, device: str | torch.device | None = None) -> torch.Tensor:
    """[n, 4, 4] camera-from-object template poses: super-Fibonacci rotation,
    object centred at (0, 0, z)."""
    rots = super_fibonacci_rotations(n, device)
    poses = torch.eye(4, device=rots.device).repeat(n, 1, 1)
    poses[:, :3, :3] = rots
    poses[:, 2, 3] = z
    return poses


# The order in which geodesic_distance sums the trace's nine products; the
# host copy (pipeline/fine_cache.py:_grid_dists_deg) sums in the same order.
TRACE_TERMS = tuple((i, j) for i in range(3) for j in range(3))


def geodesic_distance(rots: torch.Tensor, ref: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """Angle of the relative rotation between an [N, 3, 3] grid and a [3, 3]
    reference, from the trace identity cos = (tr(R_n refᵀ) - 1) / 2.

    Computed in float64 (returned as float64): the trace is the sum of the
    nine products R_n[i, j]·ref[i, j] of float32 entries, each exact in
    float64, added in one fixed order, so the CPU, the card and the numpy
    copy in pipeline/fine_cache.py give the same cosine bit for bit and
    order a pose grid alike. The JAX function works in float32; the two
    agree to float32 rounding."""
    r = rots.to(torch.float32).to(torch.float64)
    q = ref.to(torch.float32).to(torch.float64)
    tr = r[:, 0, 0] * q[0, 0]
    for i, j in TRACE_TERMS[1:]:
        tr = tr + r[:, i, j] * q[i, j]
    ang = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    return torch.rad2deg(ang) if degrees else ang


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> [..., 4] scalar-last unit quaternion,
    by Shepperd's method without branches: all four candidates, the one
    whose pivot (trace, m00, m11, m22) is largest kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def two_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s_w = two_sqrt(1.0 + tr)
    q_w = torch.stack([(m21 - m12) / s_w, (m02 - m20) / s_w, (m10 - m01) / s_w, s_w / 4.0], -1)
    s_x = two_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack([s_x / 4.0, (m01 + m10) / s_x, (m02 + m20) / s_x, (m21 - m12) / s_x], -1)
    s_y = two_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack([(m01 + m10) / s_y, s_y / 4.0, (m12 + m21) / s_y, (m02 - m20) / s_y], -1)
    s_z = two_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack([(m02 + m20) / s_z, (m12 + m21) / s_z, s_z / 4.0, (m10 - m01) / s_z], -1)
    cand = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # [..., 4, 4]
    idx = torch.stack([tr, m00, m11, m22], dim=-1).argmax(dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def average_quaternions(quats: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Markley eigen-average of [..., N, 4] quaternions -> [..., 4]: the
    eigenvector of the largest eigenvalue of the weighted outer-product
    mean (its sign is arbitrary; q and -q are one rotation)."""
    if weights is None:
        weights = torch.ones(quats.shape[:-1], dtype=quats.dtype, device=quats.device)
    a = torch.einsum("...n,...ni,...nj->...ij", weights, quats, quats) / weights.sum(dim=-1)[..., None, None]
    return torch.linalg.eigh(a)[1][..., -1]


def rotvec_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] by Rodrigues' formula, safe at 0."""
    theta = torch.linalg.norm(rotvec, dim=-1, keepdim=True)
    axis = rotvec / torch.clamp(theta, min=1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(rotvec.shape[:-1] + (3, 3))
    th = theta[..., None]
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(k.shape)
    return eye + torch.sin(th) * k + (1.0 - torch.cos(th)) * (k @ k)


def matrix_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] axis-angle (the SO(3) log map); within 1e-3
    of pi the axis comes from the quaternion's vector part."""
    cos = torch.clamp((m.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)[..., None]
    skew = torch.stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], -1)
    scale = torch.where(theta < 1e-6, 0.5, theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12))
    q = matrix_to_quat(m)
    v = q[..., :3] * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    near_pi = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12) * theta
    return torch.where(theta > torch.pi - 1e-3, near_pi, skew * scale)
