"""Crop-resize-pad: the canonical proposal preprocessing, as one batched gather.

For every output pixel the source pixel is computed analytically (bbox extend
-> isotropic scale so max side = target -> centre in a target×target canvas,
nearest sampling, zero padding), with the same integer nearest-index
arithmetic as freepose_tpu.geometry.crop, so both packages pick the same
source pixels.
"""
from __future__ import annotations

import torch

from freepose_tpu_torch.geometry.boxes import extend_and_clip_boxes


def crop_resize_pad(images: torch.Tensor, boxes: torch.Tensor, target: int, extend: float = 0.0) -> torch.Tensor:
    """Crop each box, scale isotropically to fit `target`, centre with zero pad.

    images: [N, C, H, W] float (one per box); boxes: [N, 4] xyxy (truncated
    to int). Returns [N, C, target, target].
    """
    n, c, h, w = images.shape
    fboxes = boxes.to(device=images.device, dtype=torch.float32)
    if extend:
        fboxes = extend_and_clip_boxes(fboxes, extend, w, h)
    ib = torch.floor(fboxes).to(torch.int32)
    x1, y1, x2, y2 = (ib[:, i : i + 1] for i in range(4))  # [N, 1]
    bw = torch.clamp(x2 - x1, min=1)
    bh = torch.clamp(y2 - y1, min=1)
    maxdim = torch.maximum(bw, bh)
    scale = target / maxdim.to(torch.float32)
    out_h = torch.floor(bh * scale).to(torch.int32)
    out_w = torch.floor(bw * scale).to(torch.int32)
    pad_t = torch.clamp(torch.div(target - out_h, 2, rounding_mode="floor"), min=0)
    pad_l = torch.clamp(torch.div(target - out_w, 2, rounding_mode="floor"), min=0)

    oi = torch.arange(target, dtype=torch.int32, device=images.device)[None]  # [1, T]
    ci = oi - pad_t  # [N, T] row within the resized crop
    cj = oi - pad_l
    # Nearest-neighbour source index floor(dst / scale), exactly in integers.
    si = torch.minimum(
        torch.clamp(torch.div(ci * maxdim, target, rounding_mode="floor"), min=0),
        torch.clamp(bh - 1, min=0),
    )
    sj = torch.minimum(
        torch.clamp(torch.div(cj * maxdim, target, rounding_mode="floor"), min=0),
        torch.clamp(bw - 1, min=0),
    )
    yi = torch.clamp(y1 + si, 0, h - 1).long()
    xj = torch.clamp(x1 + sj, 0, w - 1).long()
    valid = ((ci >= 0) & (ci < out_h))[:, :, None] & ((cj >= 0) & (cj < out_w))[:, None, :]

    bidx = torch.arange(n, device=images.device)[:, None, None]
    gathered = images[bidx, :, yi[:, :, None], xj[:, None, :]]  # [N, T, T, C]
    gathered = gathered.permute(0, 3, 1, 2)
    return torch.where(valid[:, None], gathered, torch.zeros((), dtype=images.dtype, device=images.device))
