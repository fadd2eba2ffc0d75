"""Masked pointcloud reductions used by the coarse-pose path."""
from __future__ import annotations

import torch


def masked_mean(values: torch.Tensor, mask: torch.Tensor, axis: int = 0) -> torch.Tensor:
    m = mask if values.ndim == mask.ndim else mask[..., None]
    s = torch.where(m, values, torch.zeros((), dtype=values.dtype, device=values.device)).sum(dim=axis)
    return s / torch.clamp(m.sum(dim=axis).to(values.dtype), min=1.0)
