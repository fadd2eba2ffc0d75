"""SA-V / DAVIS-style VOS benchmark: J&F over folders of mask PNGs.

Counterpart of the JAX package's scripts/sav_evaluator.py, with the same
arguments and outputs, on the host only (numpy and PIL, no device): the
reference's vendored evaluator
(segment-anything-2/sav_dataset/sav_evaluator.py + utils/sav_benchmark.py):
compares a prediction root against a GT root with the same layout and prints
per-video and global J / F / J&F. Two layouts are auto-detected per video:

  1. SA-V:   {root}/{video}/{obj_id}/{frame}.png   (binary mask per object)
  2. DAVIS:  {root}/{video}/{frame}.png            (id-coded multi-object PNG)

By default the first and last annotated frames are skipped (SA-V val/test
protocol, reference sav_evaluator.py:75-80).

Usage: python -m freepose_tpu_torch.scripts.sav_evaluator --gt_root GT \
         --pred_root PRED [-s] [-q] [--do_not_skip_first_and_last_frame] [--csv out.csv]
"""
from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np

from freepose_tpu_torch.evaluation.vos_metrics import track_j_and_f


def _load_mask(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def _object_tracks(video_dir: Path) -> dict[str, dict[str, np.ndarray]]:
    """-> {obj_id: {frame_name: bool mask}} for either layout."""
    subdirs = sorted(p for p in video_dir.iterdir() if p.is_dir())
    if subdirs:  # SA-V layout: per-object folders of binary masks
        return {
            d.name: {p.stem: _load_mask(p) > 0 for p in sorted(d.glob("*.png"))}
            for d in subdirs
        }
    # DAVIS layout: id-coded PNGs; objects = nonzero ids seen in any frame.
    frames = {p.stem: _load_mask(p) for p in sorted(video_dir.glob("*.png"))}
    ids = sorted({int(i) for m in frames.values() for i in np.unique(m) if i != 0})
    return {
        f"{oid:03d}": {name: m == oid for name, m in frames.items()} for oid in ids
    }


def evaluate_video(gt_dir: Path, pred_dir: Path, skip_ends: bool) -> dict:
    gt_objs = _object_tracks(gt_dir)
    pred_objs = _object_tracks(pred_dir)
    per_obj = []
    for oid, gt_frames in gt_objs.items():
        names = sorted(gt_frames)
        pred_frames = pred_objs.get(oid, {})
        h, w = next(iter(gt_frames.values())).shape
        gt = np.stack([gt_frames[n] for n in names])
        pred = np.stack(
            [pred_frames.get(n, np.zeros((h, w), bool)) for n in names]
        )
        per_obj.append(track_j_and_f(pred, gt, skip_first_and_last=skip_ends))
    return {
        "J": float(np.mean([o["J"] for o in per_obj])),
        "F": float(np.mean([o["F"] for o in per_obj])),
        "J&F": float(np.mean([o["J&F"] for o in per_obj])),
        "n_objects": len(per_obj),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--pred_root", required=True)
    ap.add_argument("-s", "--strict", action="store_true",
                    help="error if a GT video has no prediction folder")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--do_not_skip_first_and_last_frame", action="store_true")
    ap.add_argument("--csv", default=None, help="optional per-video results CSV")
    args = ap.parse_args(argv)

    gt_root, pred_root = Path(args.gt_root), Path(args.pred_root)
    skip_ends = not args.do_not_skip_first_and_last_frame
    rows = []
    for video in sorted(p for p in gt_root.iterdir() if p.is_dir()):
        pred_dir = pred_root / video.name
        if not pred_dir.is_dir():
            if args.strict:
                sys.exit(f"missing prediction for video {video.name}")
            if not args.quiet:
                print(f"skip {video.name}: no prediction folder")
            continue
        res = evaluate_video(video, pred_dir, skip_ends)
        rows.append((video.name, res))
        if not args.quiet:
            print(f"{video.name}: J {res['J']:.4f}  F {res['F']:.4f}  "
                  f"J&F {res['J&F']:.4f}  ({res['n_objects']} objects)")
    if not rows:
        sys.exit("no videos evaluated")
    g = {k: float(np.mean([r[k] for _, r in rows])) for k in ("J", "F", "J&F")}
    print(f"global: J {g['J']:.4f}  F {g['F']:.4f}  J&F {g['J&F']:.4f}  "
          f"({len(rows)} videos)")
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["video", "J", "F", "J&F", "n_objects"])
            for name, r in rows:
                w.writerow([name, r["J"], r["F"], r["J&F"], r["n_objects"]])
            w.writerow(["global", g["J"], g["F"], g["J&F"], ""])


if __name__ == "__main__":
    main()
