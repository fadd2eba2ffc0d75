"""Binary morphology: isotropic (disk) erosion with an adaptive radius ladder.

Counterpart of freepose_tpu.ops.erosion, in plain PyTorch: a pixel survives
iff no background pixel lies within the disk; beyond the border counts as
foreground (zero padding of the inverted mask). The disk hit count is a sum
of 0/1 products, exact in fp32 (and in TF32), so masks equal the JAX
package's exactly.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _disk_kernel(radius: float) -> np.ndarray:
    r = int(np.ceil(radius))
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


def isotropic_erosion(mask: torch.Tensor, radius: float) -> torch.Tensor:
    """[H, W] bool erosion by a euclidean disk of `radius`."""
    mask = mask.to(torch.bool)
    if radius <= 0:
        return mask
    kern = torch.as_tensor(_disk_kernel(radius), device=mask.device)
    inv = (~mask).to(torch.float32)[None, None]
    hits = F.conv2d(inv, kern[None, None], padding=kern.shape[-1] // 2)[0, 0]
    return mask & (hits < 0.5)


def adaptive_erosion(mask: torch.Tensor, radius: int = 8, min_pixels: int = 25) -> torch.Tensor:
    """Erode at `radius`, halving it until more than min_pixels survive;
    the uneroded mask when none does (the ladder 8, 4, 2, 1, then the
    original)."""
    mask = mask.to(torch.bool)
    ladder = []
    r = float(radius)
    while r >= 1.0:
        ladder.append(r)
        r /= 2.0
    result = mask
    for r in sorted(ladder):  # the largest radius that leaves enough pixels wins
        eroded = isotropic_erosion(mask, r)
        result = torch.where(eroded.sum() > min_pixels, eroded, result)
    return result
