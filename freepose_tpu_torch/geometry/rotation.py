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
