"""Video object segmentation metrics: J (region IoU) and F (boundary).

Counterpart of the reference's vendored SA-V / DAVIS benchmark harness
(segment-anything-2/sav_dataset/utils/sav_benchmark.py — J&F vs GT masks):
per-frame Jaccard of predicted vs GT masks, boundary F-measure via
dilated-contour precision/recall, and the J&F mean over a track.

A copy of freepose_tpu.evaluation.vos_metrics (numpy only):
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    """Region similarity J = |pred ∩ gt| / |pred ∪ gt| (1.0 for two empties)."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(pred, gt).sum() / union)


def _boundary(mask: np.ndarray) -> np.ndarray:
    """One-pixel boundary of a binary mask (mask minus its erosion)."""
    m = mask.astype(bool)
    er = m.copy()
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        er &= np.roll(m, (dy, dx), axis=(0, 1))
    # Border pixels of the image count as boundary when foreground.
    er[0, :] = er[-1, :] = False
    er[:, 0] = er[:, -1] = False
    return m & ~er


def _dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    out = mask.astype(bool).copy()
    for _ in range(radius):
        grown = out.copy()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            grown |= np.roll(out, (dy, dx), axis=(0, 1))
        out = grown
    return out


def boundary_f_measure(pred: np.ndarray, gt: np.ndarray, tolerance: float | None = None) -> float:
    """Boundary F: precision/recall of contour pixels within a tolerance band
    (DAVIS default: 0.8% of the image diagonal)."""
    h, w = pred.shape
    if tolerance is None:
        tolerance = 0.008 * np.sqrt(h * h + w * w)
    radius = max(int(np.ceil(tolerance)), 1)
    pb = _boundary(pred)
    gb = _boundary(gt)
    if pb.sum() == 0 and gb.sum() == 0:
        return 1.0
    if pb.sum() == 0 or gb.sum() == 0:
        return 0.0
    gb_zone = _dilate(gb, radius)
    pb_zone = _dilate(pb, radius)
    precision = (pb & gb_zone).sum() / pb.sum()
    recall = (gb & pb_zone).sum() / gb.sum()
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def track_j_and_f(
    pred_masks: np.ndarray, gt_masks: np.ndarray, skip_first_and_last: bool = True
) -> dict:
    """[T, H, W] predicted vs GT masks -> {"J", "F", "J&F"} means over the
    track (first and last frames excluded like the DAVIS/SA-V protocol when
    the track is long enough; reference sav_evaluator.py:75-80 exposes the
    same toggle)."""
    t = len(pred_masks)
    idx = range(1, t - 1) if (skip_first_and_last and t > 2) else range(t)
    js = [jaccard(pred_masks[i], gt_masks[i]) for i in idx]
    fs = [boundary_f_measure(pred_masks[i], gt_masks[i]) for i in idx]
    j, f = float(np.mean(js)), float(np.mean(fs))
    return {"J": j, "F": f, "J&F": (j + f) / 2.0}
