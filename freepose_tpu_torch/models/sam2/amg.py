"""Automatic-mask-generation helpers (the SAM2 AMG toolbox).

Counterpart of freepose_tpu.models.sam2.amg: point-prompt grids and
multi-layer crop boxes (numpy, built once per generator), and on tensors the
stability score, the batched mask -> box, uncropping and the crop-edge
filter. The RLE codec lives in freepose_tpu_torch/io/rle.py.
"""
from __future__ import annotations

import math
from itertools import product

import numpy as np
import torch


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n², 2] points evenly spaced in [0, 1]²."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    xs = np.tile(side[None, :], (n_per_side, 1))
    ys = np.tile(side[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int, scale_per_layer: int) -> list[np.ndarray]:
    """One point grid per crop layer, n_per_side / scale_per_layer^i points a side."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i))) for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: tuple[int, int], n_layers: int,
                        overlap_ratio: float) -> tuple[list[list[int]], list[int]]:
    """Overlapping xyxy crop boxes, (2^i)² at layer i; layer 0 is the whole
    image. Returns (boxes, layer of each box)."""
    crop_boxes, layer_idxs = [[0, 0, im_size[1], im_size[0]]], [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        cw, ch = crop_len(im_w, n_side, overlap), crop_len(im_h, n_side, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n_side)]
        y0s = [int((ch - overlap) * i) for i in range(n_side)]
        for x0, y0 in product(x0s, y0s):
            crop_boxes.append([x0, y0, min(x0 + cw, im_w), min(y0 + ch, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: torch.Tensor, crop_box: list[int]) -> torch.Tensor:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + torch.tensor([x0, y0, x0, y0], dtype=boxes.dtype, device=boxes.device)


def uncrop_points(points: torch.Tensor, crop_box: list[int]) -> torch.Tensor:
    return points + torch.tensor([crop_box[0], crop_box[1]], dtype=points.dtype, device=points.device)


def calculate_stability_score(masks: torch.Tensor, mask_threshold: float = 0.0,
                              threshold_offset: float = 1.0) -> torch.Tensor:
    """IoU of the mask logits binarised at threshold ± offset; [..., H, W] -> [...]."""
    hi = (masks > (mask_threshold + threshold_offset)).sum((-2, -1), dtype=torch.int32).to(torch.float32)
    lo = (masks > (mask_threshold - threshold_offset)).sum((-2, -1), dtype=torch.int32).to(torch.float32)
    return hi / torch.clamp(lo, min=1e-9)


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """xyxy boxes (inclusive edges) around bool masks [..., H, W] -> [..., 4]
    int64; an empty mask gives [0, 0, 0, 0]."""
    h, w = masks.shape[-2], masks.shape[-1]
    m = masks.to(torch.int64)
    in_h = m.amax(-1)  # [..., H]
    hc = in_h * torch.arange(h, device=masks.device)
    bottom = hc.amax(-1)
    top = (hc + h * (1 - in_h)).amin(-1)
    in_w = m.amax(-2)  # [..., W]
    wc = in_w * torch.arange(w, device=masks.device)
    right = wc.amax(-1)
    left = (wc + w * (1 - in_w)).amin(-1)
    empty = (right < left) | (bottom < top)
    out = torch.stack([left, top, right, bottom], dim=-1)
    return torch.where(empty[..., None], 0, out)


def is_box_near_crop_edge(boxes: torch.Tensor, crop_box: list[int], orig_box: list[int],
                          atol: float = 20.0) -> torch.Tensor:
    """True for xyxy boxes (in crop coordinates) near the crop's edge but not
    near the image's: such masks are artefacts of the crop."""
    crop = torch.tensor(crop_box, dtype=torch.float32, device=boxes.device)
    orig = torch.tensor(orig_box, dtype=torch.float32, device=boxes.device)
    b = uncrop_boxes_xyxy(boxes.to(torch.float32), crop_box)
    near_crop = torch.isclose(b, crop[None], atol=atol, rtol=0)
    near_image = torch.isclose(b, orig[None], atol=atol, rtol=0)
    return (near_crop & ~near_image).any(dim=1)
