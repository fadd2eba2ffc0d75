"""SE(3) track smoothing, frozen: a copy of the port's geometry/se3.py
(`smooth_transforms`) at the commit that added the smooth cell. Translations
take a moving average over 5 frames, rotations a Markley quaternion
eigen-average over 9 frames, both windows clipped at the ends of the
track."""
from __future__ import annotations

import torch

from benchmark.reference.frozen.rotation import average_quaternions, matrix_to_quat, quat_to_matrix


def _windows(n: int, window: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """For each frame i, the frames [i - w//2, i + w//2] clipped to [0, n)
    -> (indices [n, w], weights [n, w]: 0 for the clipped duplicates)."""
    offs = torch.arange(-(window // 2), window // 2 + 1, device=device)
    idx = torch.arange(n, device=device)[:, None] + offs[None]
    valid = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), valid.to(torch.float32)


def smooth_transforms(tcos: torch.Tensor, t_window: int = 5, r_window: int = 9) -> torch.Tensor:
    """[N, 4, 4] pose track -> the track with smoothed translations and
    rotations (float32)."""
    tcos = torch.as_tensor(tcos, dtype=torch.float32)
    out = tcos.clone()
    idx, w = _windows(tcos.shape[0], t_window, tcos.device)
    xyz = tcos[:, :3, 3]
    out[:, :3, 3] = (xyz[idx] * w[..., None]).sum(dim=1) / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
    idx, w = _windows(tcos.shape[0], r_window, tcos.device)
    quats = matrix_to_quat(tcos[:, :3, :3])
    out[:, :3, :3] = quat_to_matrix(average_quaternions(quats[idx], w))
    return out
