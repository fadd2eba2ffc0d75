"""SE(3) helpers and pose-track smoothing.

Counterpart of freepose_tpu.geometry.se3: translations are smoothed by a
moving average over 5 frames, rotations by a Markley quaternion eigen-average
over 9 frames, both with windows clipped at the ends of the track. Every
frame's window is gathered at once with zero weights past the ends; the JAX
package's padding of the track to a frame bucket (one compiled program for
every length) has no counterpart here, and the result is the same at any
length.
"""
from __future__ import annotations

import torch

from freepose_tpu_torch.geometry.rotation import (average_quaternions, matrix_to_quat, matrix_to_rotvec,
                                                   quat_to_matrix, rotvec_to_matrix)


def se3_inverse(t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid transform -> its inverse."""
    rt = t[..., :3, :3].transpose(-1, -2)
    inv = torch.zeros_like(t)
    inv[..., :3, :3] = rt
    inv[..., :3, 3] = -torch.einsum("...ij,...j->...i", rt, t[..., :3, 3])
    inv[..., 3, 3] = 1.0
    return inv


def make_se3(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation + [..., 3] translation -> [..., 4, 4]."""
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def so3_log(r: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotvec(r)


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    return rotvec_to_matrix(v)


def _windows(n: int, window: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """For each frame i, the frames [i - w//2, i + w//2] clipped to [0, n)
    -> (indices [n, w], weights [n, w]: 0 for the clipped duplicates)."""
    offs = torch.arange(-(window // 2), window // 2 + 1, device=device)
    idx = torch.arange(n, device=device)[:, None] + offs[None]
    valid = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), valid.to(torch.float32)


def smooth_translations(xyz: torch.Tensor, window: int = 5) -> torch.Tensor:
    """[N, 3] moving average over `window` frames."""
    idx, w = _windows(xyz.shape[0], window, xyz.device)
    return (xyz[idx] * w[..., None]).sum(dim=1) / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)


def smooth_quaternions(quats: torch.Tensor, window: int = 9) -> torch.Tensor:
    """[N, 4] Markley average over `window` frames."""
    idx, w = _windows(quats.shape[0], window, quats.device)
    return average_quaternions(quats[idx], w)


def smooth_transforms(tcos: torch.Tensor, t_window: int = 5, r_window: int = 9) -> torch.Tensor:
    """[N, 4, 4] pose track -> the track with smoothed translations and
    rotations (float32)."""
    tcos = torch.as_tensor(tcos, dtype=torch.float32)
    out = tcos.clone()
    out[:, :3, 3] = smooth_translations(tcos[:, :3, 3], t_window)
    out[:, :3, :3] = quat_to_matrix(smooth_quaternions(matrix_to_quat(tcos[:, :3, :3]), r_window))
    return out
