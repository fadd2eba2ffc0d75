"""Feature visualisation: PCA of patch features as RGB, nearest-neighbour
upscale to pixels, and a side-by-side panel (image | features | mask |
masked features).

Counterpart of freepose_tpu.utils.viz. The PCA is one torch.linalg.svd on
the features' device. A principal component's sign is arbitrary: each
channel can come out as 1 - c of the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch


def pca_rgb(feats: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Project [H, W, C] features onto their top 3 principal components and
    min-max normalise each channel to [0, 1]. With `mask` [H, W] bool the
    basis is fit on the masked-in features only, and masked-out pixels are
    black."""
    h, w, c = feats.shape
    x = feats.reshape(-1, c).to(torch.float32)
    if mask is not None:
        m = mask.reshape(-1, 1).to(torch.float32)
        mean = (x * m).sum(0) / torch.clamp(m.sum(), min=1.0)
        xc = (x - mean) * m
    else:
        xc = x - x.mean(0)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    proj = xc @ vt[:3].T  # [H·W, 3]
    lo, hi = proj.min(0, keepdim=True).values, proj.max(0, keepdim=True).values
    rgb = (proj - lo) / torch.clamp(hi - lo, min=1e-12)
    if mask is not None:
        rgb = rgb * mask.reshape(-1, 1)
    return rgb.reshape(h, w, 3)


def nearest_upscale(img: np.ndarray, factor: int) -> np.ndarray:
    """[H, W, ...] -> [H·f, W·f, ...] by pixel replication."""
    return np.repeat(np.repeat(np.asarray(img), factor, axis=0), factor, axis=1)


def feature_panel(image: np.ndarray, feats, mask: np.ndarray | None = None, patch: int = 14) -> np.ndarray:
    """Horizontal uint8 panel [image | PCA(feats) | mask | PCA(masked
    feats)]: `image` [H, W, 3] uint8 at the patch grid times `patch`,
    `feats` the [h, w, C] patch-feature grid (a tensor keeps its device for
    the PCA), `mask` [h, w] bool or None (then two tiles)."""
    feats = torch.as_tensor(feats)
    panels = [np.asarray(image, np.uint8)]
    rgb = pca_rgb(feats).cpu().numpy()
    panels.append(nearest_upscale((rgb * 255).astype(np.uint8), patch))
    if mask is not None:
        mask = np.asarray(mask, bool)
        panels.append(nearest_upscale(np.stack([mask.astype(np.uint8) * 255] * 3, -1), patch))
        mrgb = pca_rgb(feats, torch.as_tensor(mask, device=feats.device)).cpu().numpy()
        panels.append(nearest_upscale((mrgb * 255).astype(np.uint8), patch))
    hh = max(p.shape[0] for p in panels)
    panels = [np.pad(p, ((0, hh - p.shape[0]), (0, 0), (0, 0))) if p.shape[0] < hh else p for p in panels]
    return np.concatenate(panels, axis=1)
