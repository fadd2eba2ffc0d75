"""Video frame loading: a directory of JPEG/PNG frames -> [T, H, W, 3] uint8.

A copy of the eager loader of freepose_tpu.datasets.video (numpy and PIL
only). Frames stay uint8 RGB; resizing and normalisation happen on the
device in the consumers (models/sam2/predictor.py:prepare_image).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png")


def list_frame_paths(video_dir: str | Path) -> list[Path]:
    paths: list[Path] = []
    for ext in _EXTS:
        paths.extend(Path(video_dir).glob(f"*{ext}"))
    return sorted(paths)


def _decode(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_frame_dir(video_dir: str | Path) -> np.ndarray:
    """[T, H, W, 3] uint8, eagerly."""
    paths = list_frame_paths(video_dir)
    if not paths:
        raise FileNotFoundError(f"no frames under {video_dir}")
    return np.stack([_decode(p) for p in paths])
