"""Bounding-box utilities (mask -> bbox, extend-and-clip, IoU, greedy NMS),
counterparts of freepose_tpu.geometry.boxes."""
from __future__ import annotations

import torch


def mask_to_bbox(mask: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool mask -> [..., 4] xyxy int64 bbox. An empty mask gives
    (W, H, -1, -1), as the masked reductions of the JAX version do."""
    h, w = mask.shape[-2:]
    ys = torch.arange(h, device=mask.device)
    xs = torch.arange(w, device=mask.device)
    row_any = mask.any(dim=-1)
    col_any = mask.any(dim=-2)
    y_min = torch.where(row_any, ys, h).amin(dim=-1)
    y_max = torch.where(row_any, ys, -1).amax(dim=-1)
    x_min = torch.where(col_any, xs, w).amin(dim=-1)
    x_max = torch.where(col_any, xs, -1).amax(dim=-1)
    return torch.stack([x_min, y_min, x_max, y_max], dim=-1)


def extend_and_clip_boxes(boxes: torch.Tensor, extend: float, w: int, h: int) -> torch.Tensor:
    """Grow xyxy boxes by `extend` * size on every side, clipped to the image."""
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    x1 = torch.clamp(boxes[..., 0] - extend * bw, min=0.0)
    x2 = torch.clamp(boxes[..., 2] + extend * bw, max=float(w))
    y1 = torch.clamp(boxes[..., 1] - extend * bh, min=0.0)
    y2 = torch.clamp(boxes[..., 3] + extend * bh, max=float(h))
    return torch.stack([x1, y1, x2, y2], dim=-1)
