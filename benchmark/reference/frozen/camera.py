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


def project_points(points: torch.Tensor, k: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """[..., N, 3] camera-frame points + [..., 3, 3] intrinsics -> [..., N, 2] pixels."""
    uvw = torch.einsum("...ij,...nj->...ni", k, points)
    return uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=eps)


def transform_points(points: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] points through [..., 4, 4] rigid transforms."""
    return torch.einsum("...ij,...nj->...ni", t[..., :3, :3], points) + t[..., None, :3, 3]


def update_k_with_crop(k: torch.Tensor, bboxes: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Intrinsics [3, 3] adjusted for a crop of each xyxy box [N, 4] resized
    to (out_h, out_w) -> [N, 3, 3]."""
    crop_w = bboxes[:, 2] - bboxes[:, 0]
    crop_h = bboxes[:, 3] - bboxes[:, 1]
    crop_cx = (bboxes[:, 0] + bboxes[:, 2]) / 2.0
    crop_cy = (bboxes[:, 1] + bboxes[:, 3]) / 2.0
    cx = k[0, 2] + (crop_w - 1.0) / 2.0 - crop_cx
    cy = k[1, 2] + (crop_h - 1.0) / 2.0 - crop_cy
    scale_x = out_w / crop_w
    scale_y = out_h / crop_h
    new_k = k.expand(bboxes.shape[0], 3, 3).clone()
    new_k[:, 0, 0] = scale_x * k[0, 0]
    new_k[:, 1, 1] = scale_y * k[1, 1]
    new_k[:, 0, 2] = (out_w - 1.0) / 2.0 + scale_x * (cx - (crop_w - 1.0) / 2.0)
    new_k[:, 1, 2] = (out_h - 1.0) / 2.0 + scale_y * (cy - (crop_h - 1.0) / 2.0)
    return new_k


def crop_bbox_around_projection(t: torch.Tensor, points: torch.Tensor, k: torch.Tensor, render_w: int,
                                render_h: int, lamb: float = 1.4) -> torch.Tensor:
    """Object-centred crop boxes from projected model points: poses [B, 4, 4],
    model points [N, 3] -> [B, 4] xyxy, `lamb` times the projection's
    largest extent from the projected centre."""
    uv = project_points(transform_points(points[None], t), k, eps=0.01)  # [B, N, 2]
    bb_min = uv.amin(dim=1)
    bb_max = uv.amax(dim=1)
    c_uv = project_points(transform_points(points.mean(dim=0, keepdim=True)[None], t), k, eps=0.01)[:, 0]
    dists = torch.maximum((bb_min - c_uv).abs(), (bb_max - c_uv).abs())
    xd, yd = dists[:, 0], dists[:, 1]
    r = render_w / render_h
    width = torch.maximum(xd, yd * r) * 2.0 * lamb
    height = torch.maximum(xd / r, yd) * 2.0 * lamb
    return torch.stack([c_uv[:, 0] - width / 2, c_uv[:, 1] - height / 2,
                        c_uv[:, 0] + width / 2, c_uv[:, 1] + height / 2], dim=1)
