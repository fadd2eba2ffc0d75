"""Masked pointcloud ops: scale estimation, outlier rejection, SVD alignment.

Counterpart of freepose_tpu.geometry.pointcloud: static [H*W]-shaped buffers
with validity masks, reductions masked instead of boolean-indexed.
"""
from __future__ import annotations

import torch

from benchmark.reference.frozen.camera import masked_minmax


def masked_mean(values: torch.Tensor, mask: torch.Tensor, axis: int = 0) -> torch.Tensor:
    m = mask if values.ndim == mask.ndim else mask[..., None]
    s = torch.where(m, values, torch.zeros((), dtype=values.dtype, device=values.device)).sum(dim=axis)
    return s / torch.clamp(m.sum(dim=axis).to(values.dtype), min=1.0)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the valid entries of a 1-D array; an even count averages
    the two central values (numpy's convention)."""
    n = values.shape[0]
    big = torch.finfo(values.dtype).max
    sorted_vals = torch.sort(torch.where(mask, values, big)).values
    cnt = mask.sum()
    hi = torch.clamp((cnt - 1) // 2 + (cnt - 1) % 2, 0, n - 1)
    lo = torch.clamp((cnt - 1) // 2, 0, n - 1)
    return (sorted_vals[lo] + sorted_vals[hi]) / 2.0


def masked_std(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mu = masked_mean(values, mask)
    return torch.sqrt(masked_mean((values - mu) ** 2, mask))


def reject_depth_outliers(z: torch.Tensor, valid: torch.Tensor, std_factor: float = 1.5,
                          min_vertices: int = 25) -> torch.Tensor:
    """Keep depths within std_factor·std of the median (<=, so a flat cloud
    keeps every point), and always the min_vertices valid points closest to
    the median (ranked by a stable sort, as jnp.argsort ranks)."""
    med = masked_median(z, valid)
    std = masked_std(z, valid)
    dist = torch.abs(z - med)
    inlier = valid & (dist <= std * std_factor)
    big = torch.finfo(z.dtype).max
    order = torch.argsort(torch.where(valid, dist, big), stable=True)
    rank = torch.argsort(order, stable=True)
    return inlier | (valid & (rank < min_vertices))


def svd_align(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rotate a padded pointcloud into its principal axes. The singular
    vectors' signs may differ from the JAX package's; extents do not."""
    mu = masked_mean(points, valid)
    x = torch.where(valid[:, None], points - mu, torch.zeros((), dtype=points.dtype, device=points.device))
    _, _, vt = torch.linalg.svd(x.T @ x)
    return points @ vt.T


def bbox_half_extent(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Half of the largest axis-aligned extent: the 'scale' of a cloud."""
    extents = [hi - lo for lo, hi in (masked_minmax(points[:, i], valid) for i in range(3))]
    return torch.maximum(torch.maximum(extents[0], extents[1]), extents[2]) / 2.0


def backproject_flat(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Dense pinhole backprojection of [H, W] depth -> [H*W, 3] points."""
    h, w = depth.shape
    vv, uu = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device), indexing="ij")
    z = depth.reshape(-1)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    x = (uu.reshape(-1) - cx) * z / fx
    y = (vv.reshape(-1) - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def pointcloud_from_mask(depth: torch.Tensor, k: torch.Tensor, mask: torch.Tensor, std_factor: float = 1.5,
                         min_vertices: int = 25, svd: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked backprojection + outlier rejection (+ SVD alignment): ([H*W, 3]
    points, [H*W] valid). The caller takes the largest component and erodes
    `mask` first (ops/connected_components.py, ops/erosion.py)."""
    z = depth.reshape(-1)
    valid = mask.reshape(-1).to(torch.bool) & (z > 0)
    valid = reject_depth_outliers(z, valid, std_factor, min_vertices)
    pts = backproject_flat(depth, k)
    if svd:
        pts = svd_align(pts, valid)
    return pts, valid
