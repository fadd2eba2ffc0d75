"""Bounding-box utilities (mask -> bbox, extend-and-clip, IoU, greedy NMS),
counterparts of freepose_tpu.geometry.boxes."""
from __future__ import annotations

import numpy as np
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


def bbox_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xywh boxes, broadcasting over leading dims; 0 where the union
    is empty."""
    tlx = torch.maximum(a[..., 0], b[..., 0])
    tly = torch.maximum(a[..., 1], b[..., 1])
    w = torch.minimum(a[..., 0] + a[..., 2], b[..., 0] + b[..., 2]) - tlx
    h = torch.minimum(a[..., 1] + a[..., 3], b[..., 1] + b[..., 3]) - tly
    inter = torch.where((w > 0) & (h > 0), w * h, 0.0)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return torch.where(union > 0, inter / union, 0.0)


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy non-maximum suppression over xyxy boxes -> kept indices in
    descending-score order, equal scores in index order (a stable sort);
    a box is dropped when its IoU with a kept box exceeds the threshold
    (torchvision.ops.nms semantics). Host numpy, as in the JAX package: the
    automatic mask generator's candidates are few and data-dependent."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32).reshape(-1)
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    iw = np.maximum(np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None]), 0)
    ih = np.maximum(np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None]), 0)
    inter = iw * ih
    union = areas[:, None] + areas[None] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    keep = []
    alive = np.ones(len(boxes), bool)
    for i in np.argsort(-scores, kind="stable"):
        if not alive[i]:
            continue
        keep.append(i)
        alive &= iou[i] <= iou_threshold
        alive[i] = False
    return np.asarray(keep, np.int64)
