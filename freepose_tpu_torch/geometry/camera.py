"""Pinhole camera math used by the coarse-pose and scale paths."""
from __future__ import annotations

import torch


def backproject_depth(depth: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense depth map [..., H, W] -> pointcloud with validity mask.

    Keeps the full [..., H*W, 3] grid plus a mask (static shape, masked
    reductions downstream), as freepose_tpu.geometry.camera does. `k` is
    [3, 3], or [..., 3, 3] matching the leading dims of `depth`.

    Returns (points [..., H*W, 3], valid [..., H*W] bool).
    """
    h, w = depth.shape[-2:]
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij",
    )
    fx, fy = k[..., 0, 0, None, None], k[..., 1, 1, None, None]
    cx, cy = k[..., 0, 2, None, None], k[..., 1, 2, None, None]
    z = depth
    x = (uu - cx) * z / fx
    y = (vv - cy) * z / fy
    pts = torch.stack([x, y, z], dim=-1).reshape(depth.shape[:-2] + (h * w, 3))
    valid = depth.reshape(depth.shape[:-2] + (h * w,)) > 0
    return pts, valid


def masked_minmax(values: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Min and max of `values` where mask; with no valid entry (+max, -max)
    of the dtype, as in the JAX package."""
    big = torch.finfo(values.dtype).max
    return torch.where(mask, values, big).min(), torch.where(mask, values, -big).max()


def default_video_intrinsics(w: int, h: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Synthetic K for uncalibrated video: f = the image diagonal, principal
    point at the centre."""
    f = float(torch.sqrt(torch.tensor(w * w + h * h, dtype=dtype)))
    return torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]], dtype=dtype, device=device)
