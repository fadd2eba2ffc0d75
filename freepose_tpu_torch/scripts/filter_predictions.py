"""Keep the tracked object whose boxes best overlap the ground truth.

Counterpart of the JAX package's scripts/filter_predictions.py, on the host
(no device): for a video proposal JSON with several tracks, the track with
the highest mean IoU between its per-frame xywh boxes and the GT boxes is
written to `*_best_object.json`.

Usage: python -m freepose_tpu_torch.scripts.filter_predictions \
         --proposals props.json --gt video_gt.npy [--out kept.json]
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.geometry.boxes import bbox_iou
from freepose_tpu_torch.io.proposals_json import load_proposals, save_proposals


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--proposals", required=True)
    ap.add_argument("--gt", required=True, help="video GT .npy (dict with 'bboxes' xywh per frame)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    props = load_proposals(args.proposals)
    gt_boxes = torch.as_tensor(np.asarray(np.load(args.gt, allow_pickle=True).item()["bboxes"], np.float32))

    by_track: dict = defaultdict(list)
    for p in props:
        by_track[p.get("track_id", p["mesh"])].append(p)
    best_track, best_iou = None, -1.0
    for tid, plist in by_track.items():
        ious = [float(bbox_iou(torch.as_tensor(p["bbox"], dtype=torch.float32), gt_boxes[p["image_id"]]))
                for p in plist if p["image_id"] < len(gt_boxes)]
        mean_iou = float(np.mean(ious)) if ious else 0.0
        if mean_iou > best_iou:
            best_track, best_iou = tid, mean_iou

    kept = by_track[best_track]
    out = args.out or str(Path(args.proposals).with_suffix("")) + "_best_object.json"
    save_proposals(kept, out)
    print(f"kept track {best_track} (mean IoU {best_iou:.3f}, {len(kept)} frames) -> {out}")


if __name__ == "__main__":
    main()
