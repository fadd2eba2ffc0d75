"""Draw each frame's proposal boxes onto the video's frames and write them
as JPEGs (counterpart of the JAX package's scripts/vis_detections_video.py;
host only: numpy and PIL).

    python -m freepose_tpu_torch.scripts.vis_detections_video --video-dir FRAMES \
        --proposals props.json --out-dir OUT
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from freepose_tpu_torch.datasets.video import load_frame_dir
from freepose_tpu_torch.io.proposals_json import load_proposals


def draw_box(img: np.ndarray, box, color=(255, 40, 40), width: int = 2) -> None:
    """Draw an xywh box's outline `width` pixels wide into img, in place."""
    x1, y1, w_, h_ = [int(v) for v in box]
    x2, y2 = x1 + w_, y1 + h_
    h, w = img.shape[:2]
    x1, x2 = np.clip([x1, x2], 0, w - 1)
    y1, y2 = np.clip([y1, y2], 0, h - 1)
    img[y1:y1 + width, x1:x2] = color
    img[max(y2 - width, 0):y2, x1:x2] = color
    img[y1:y2, x1:x1 + width] = color
    img[y1:y2, max(x2 - width, 0):x2] = color


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--proposals", required=True)
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    from PIL import Image

    frames = load_frame_dir(args.video_dir)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    by_frame: dict[int, list] = {}
    for p in load_proposals(args.proposals):
        by_frame.setdefault(p["image_id"], []).append(p)
    for f in range(len(frames)):
        img = frames[f].copy()
        for p in by_frame.get(f, []):
            draw_box(img, p["bbox"])
        Image.fromarray(img).save(out / f"{f:06d}.jpg")
    print(f"annotated {len(frames)} frames -> {out}")


if __name__ == "__main__":
    main()
