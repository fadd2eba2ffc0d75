"""Proposal JSON read/write (BOP-detection format).

Wire-compatible with the reference's proposal artifacts
(Proposals.to_bop_dict, reference src/pipeline/utils.py:54-69): a JSON list of
{bbox (xywh), segmentation (uncompressed RLE), mesh, score, scene_id,
image_id, time[, scale]}.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from freepose_tpu_torch.io.rle import decode_rle, encode_rle


def proposal_entry(
    bbox_xyxy: np.ndarray,
    mask: np.ndarray,
    mesh: str,
    score: float,
    scene_id: int,
    image_id: int,
    time: float = 0.01,
    scale: float | None = None,
) -> dict:
    x1, y1, x2, y2 = [int(v) for v in np.asarray(bbox_xyxy).reshape(-1)[:4]]
    entry = {
        "bbox": [x1, y1, x2 - x1, y2 - y1],
        "segmentation": encode_rle(mask),
        "mesh": mesh,
        "score": float(score),
        "scene_id": int(scene_id),
        "image_id": int(image_id),
        "time": float(time),
    }
    if scale is not None:
        entry["scale"] = float(scale)
    return entry


def save_proposals(proposals: list[dict], path: str | Path) -> None:
    with Path(path).open("w") as f:
        json.dump(proposals, f)


def load_proposals(path: str | Path) -> list[dict]:
    with Path(path).open() as f:
        return json.load(f)


def proposal_mask(entry: dict) -> np.ndarray:
    return decode_rle(entry["segmentation"])


def proposal_bbox_xyxy(entry: dict) -> np.ndarray:
    x, y, w, h = entry["bbox"]
    return np.array([x, y, x + w, y + h], dtype=np.float64)


def filter_by_frame(proposals: list[dict], scene_id: int, image_id: int) -> list[dict]:
    return [p for p in proposals if p["scene_id"] == scene_id and p["image_id"] == image_id]
