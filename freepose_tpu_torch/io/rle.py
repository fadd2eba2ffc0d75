"""Uncompressed RLE mask codec (pycocotools convention).

Wire-compatible with the proposal JSON the reference emits
(`mask_to_rle_pytorch` / `rle_to_mask`, reference
segment-anything-2/sam2/utils/amg.py:109-151): masks are flattened in
column-major (Fortran) order and encoded as alternating run lengths starting
with a zero-run. This is a host-side IO codec, so it is vectorized numpy (the
device never sees RLE; masks cross the host boundary as dense arrays).
"""
from __future__ import annotations

import numpy as np


def encode_rle(mask: np.ndarray) -> dict:
    """[H, W] bool/int mask -> {"size": [H, W], "counts": [...]} dict."""
    mask = np.asarray(mask)
    h, w = mask.shape
    flat = (mask != 0).transpose().reshape(-1)  # Fortran order
    if flat.size == 0:
        return {"size": [h, w], "counts": []}
    # Run boundaries: positions where the value changes.
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    starts = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(starts).tolist()
    counts = runs if not flat[0] else [0] + runs
    return {"size": [int(h), int(w)], "counts": [int(c) for c in counts]}


def decode_rle(rle: dict) -> np.ndarray:
    """RLE dict -> [H, W] bool mask."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], dtype=np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != H*W {h * w}")
    # Alternate 0-runs and 1-runs.
    vals = np.zeros(len(counts), dtype=bool)
    vals[1::2] = True
    flat = np.repeat(vals, counts)
    return flat.reshape(w, h).transpose()


def encode_rle_batch(masks: np.ndarray) -> list[dict]:
    """[N, H, W] -> list of RLE dicts."""
    return [encode_rle(m) for m in masks]


def rle_area(rle: dict) -> int:
    """Foreground pixel count straight from the runs
    (reference amg.py:154-155)."""
    return int(sum(rle["counts"][1::2]))
