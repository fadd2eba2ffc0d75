"""SAM2 image and mask transforms: preprocessing and mask postprocessing.

Counterpart of freepose_tpu.models.sam2.transforms: resize to the square
model input and normalise on the way in; on the way out, clean the
binarised low-res masks (fill small background holes, remove small
speckles: the two uses of the reference's CUDA connected-components
kernel), then upscale to the original resolution and threshold at 0.5. The
cleanup runs on the masks' device (ops/connected_components.py), or with
use_native on the host through the g++-built library (ops/cc_native.py).
"""
from __future__ import annotations

import numpy as np
import torch

from freepose_tpu_torch.models.sam2.model import sam2_normalize
from freepose_tpu_torch.ops.connected_components import remove_small_components
from freepose_tpu_torch.ops.sampling import resize_bilinear


def preprocess(image: torch.Tensor, size: int = 1024) -> torch.Tensor:
    """[H, W, 3] uint8 or float -> [1, 3, size, size] normalised."""
    img = image.to(torch.float32)
    if image.dtype == torch.uint8:
        img = img / 255.0
    return sam2_normalize(resize_bilinear(img.permute(2, 0, 1), (size, size))[None])


def postprocess_masks(low_res_logits: torch.Tensor, orig_hw: tuple[int, int], mask_threshold: float = 0.0,
                      fill_hole_area: int = 8, use_native: bool = False) -> np.ndarray:
    """Logits [N, h, w] -> cleaned bool masks [N, H, W] at the original
    resolution (numpy). Hole filling and speckle removal run at the low-res
    scale, before the bilinear upscale."""
    masks = low_res_logits > mask_threshold
    if fill_hole_area > 0:
        if use_native:
            from freepose_tpu_torch.ops.cc_native import remove_small_components as native_rm

            masks = torch.as_tensor(native_rm(masks.cpu().numpy(), fill_hole_area), device=masks.device)
        elif masks.shape[0]:
            masks = torch.stack([remove_small_components(m, fill_hole_area) for m in masks])
    up = resize_bilinear(masks.to(torch.float32), orig_hw)
    return (up > 0.5).cpu().numpy()
