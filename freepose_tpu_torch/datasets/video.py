"""Video frame loading: a directory of JPEG/PNG frames -> [T, H, W, 3] uint8.

A copy of freepose_tpu.datasets.video's eager loader and its
AsyncVideoFrameLoader (numpy, PIL and a thread), and `stage_frames`, the
port's counterpart of the JAX module's StagedVideo: the whole video as one
uint8 tensor on the device (no padding to a frame bucket, since no compiled
program is shared across lengths). Frames stay uint8 RGB; resizing and
normalisation happen on the device in the consumers
(models/sam2/predictor.py:prepare_image).
"""
from __future__ import annotations

import threading
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


def stage_frames(frames: np.ndarray, device) -> "torch.Tensor":
    """[T, H, W, 3] uint8 -> the same uint8 tensor on `device`, uploaded once;
    consumers slice chunks and gather interval frames there."""
    import torch

    return torch.as_tensor(np.asarray(frames, np.uint8)).to(device)


class AsyncVideoFrameLoader:
    """Indexable lazy frame list with a background decode thread.

    Frame 0 decodes at once (it sets video_height/width); the rest decode in
    order on a daemon thread. An exception in the thread is raised again at
    the next access."""

    def __init__(self, video_dir: str | Path):
        self.paths = list_frame_paths(video_dir)
        if not self.paths:
            raise FileNotFoundError(f"no frames under {video_dir}")
        self._frames: list[np.ndarray | None] = [None] * len(self.paths)
        self._lock = threading.Lock()
        self.exception: BaseException | None = None

        first = self[0]
        self.video_height, self.video_width = first.shape[:2]

        def _worker():
            try:
                for i in range(len(self.paths)):
                    self._ensure(i)
            except BaseException as e:  # surfaced on the next __getitem__
                self.exception = e

        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()

    def _ensure(self, index: int) -> np.ndarray:
        frame = self._frames[index]
        if frame is None:
            frame = _decode(self.paths[index])
            with self._lock:
                if self._frames[index] is None:
                    self._frames[index] = frame
                frame = self._frames[index]
        return frame

    def __getitem__(self, index: int) -> np.ndarray:
        if self.exception is not None:
            raise RuntimeError("failure in frame loading thread") from self.exception
        return self._ensure(index)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def shape(self):  # duck-types the eager [T, H, W, 3] array
        return (len(self.paths), self.video_height, self.video_width, 3)

    def join(self) -> None:
        self._thread.join()
