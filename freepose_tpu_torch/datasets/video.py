"""Video frame loading: a directory of JPEG/PNG frames -> [T, H, W, 3] uint8.

A copy of freepose_tpu.datasets.video's eager loader and its
AsyncVideoFrameLoader (numpy, PIL and a thread), and its StagedVideo: the
whole video in the card's memory after one upload, at a frame bucket
(`stage_frames_hbm`), which the coupled video step (SAM2 propagate_batched)
and StreamingInliers slice on the device. `stage_frames` is the unpadded
tensor of the same upload. Frames stay uint8 RGB; resizing and
normalisation happen on the device in the consumers
(models/sam2/predictor.py:prepare_image).
"""
from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png")

FRAME_BUCKET = 128


@dataclasses.dataclass(frozen=True)
class StagedVideo:
    """A whole video on the device at a frame bucket: `frames` [B, H, W, 3]
    uint8 with B a multiple of the bucket (rows >= n repeat the last real
    frame, as the chunked consumers pad a tail); `n` the true frame count.
    Consumers slice chunks on the device, so a chunk costs no host upload."""

    frames: "torch.Tensor"
    n: int

    def __len__(self) -> int:
        return self.n

    def prefix(self, n: int) -> "StagedVideo":
        """A shorter logical video on the same device buffer."""
        return dataclasses.replace(self, n=min(n, self.n))


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


def stage_frames_hbm(frames: np.ndarray, bucket: int = FRAME_BUCKET, device=None) -> StagedVideo:
    """One host-to-device upload of the whole [T, H, W, 3] uint8 video on
    `device` (default cuda), padded to a multiple of `bucket` frames with
    repeats of the last frame."""
    import torch

    from freepose_tpu_torch.device import resolve_device
    from freepose_tpu_torch.utils import timing

    frames = np.asarray(frames, np.uint8)
    n = len(frames)
    if n == 0:
        raise ValueError("stage_frames_hbm: empty frame array")
    with timing.span("stage"):
        b = -(-n // bucket) * bucket
        if b > n:
            frames = np.concatenate([frames, np.repeat(frames[-1:], b - n, axis=0)])
        with timing.wait("stage.upload"):  # an upload from pageable memory synchronises
            return StagedVideo(torch.as_tensor(frames).to(resolve_device(device)), n)


def stage_frames(frames: np.ndarray, device) -> "torch.Tensor":
    """[T, H, W, 3] uint8 -> the same uint8 tensor on `device`, uploaded once
    (`stage_frames_hbm` with no padding); consumers slice chunks and gather
    interval frames there."""
    return stage_frames_hbm(frames, bucket=1, device=device).frames


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
