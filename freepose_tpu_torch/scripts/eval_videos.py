"""Video pose evaluation: rotation / projection / depth drift tables.

Counterpart of the JAX package's scripts/eval_videos.py, with the same
arguments and the same result CSVs, on the host only (numpy and pandas, no
device): the reference's scripts/eval_videos.py: loads per-video GT
(.npy dicts with poses/bboxes/mesh_id/focal_length/sym_axis), reads each
method's CSV by filename pattern, computes the drift metrics over
dt = linspace(1, N/2, 10), and writes results_{rot,proj,depth}.csv +
results_mean.csv. GT object scale fixed at 0.15 m half-extent
(reference eval_videos.py:47).

Usage: python -m freepose_tpu_torch.scripts.eval_videos --gt-dir GT \
         --results-dir CSVS [--methods name={video}.csv ...] [--videos v1 v2] \
         [--width 1920 --height 1080] [--out-dir tables]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from freepose_tpu_torch.evaluation import video_metrics as vm
from freepose_tpu_torch.io.bop_csv import read_results_csv

GT_SCALE = 0.15

# Canonical 32-video benchmark set (reference eval_videos.py:118-151).
DEFAULT_VIDEOS = [
    "bowl1", "bowl2", "bowl3", "bowl4", "bowl5", "bowl6", "bowl7",
    "campbells1", "campbells2", "campbells3", "campbells4",
    "cups", "jug", "juice",
    "pour_268", "pour_805", "pour_2100", "pour_2257", "pour_2866",
    "pour_4168", "pour_4711",
    "pour_from_7369", "pour_from_8021", "pour_from_10591",
    "pour_in_1110", "pour_in_10109",
    "pour_into_1771", "pour_into_6685",
    "pour_onto_10437", "pour_into_8625", "pour_onto_8316",
    "spoons",
]

# Default method labels + CSV filename patterns (reference
# eval_videos.py:240-256): the paper's comparison table — MegaPose
# coarse/fine, GigaPose, FoundPose, and this pipeline's coarse/fine outputs.
DEFAULT_METHODS = [
    ("MegaPose coarse",
     "props-ground-box-0.2-text-0.2-ffa-22-top-25_{video}_gpt4_scaled_best_"
     "object_megapose_coarse.csv"),
    ("MegaPose fine",
     "props-ground-box-0.2-text-0.2-ffa-22-top-25_{video}_gpt4_scaled_best_"
     "object_megapose_coarse_ref.csv"),
    ("GigaPose", "gigapose_{video}_rescaled.csv"),
    ("FoundPose", "foundpose_{video}_rescaled.csv"),
    ("Ours coarse",
     "props-ground-box-0.2-text-0.2-ffa-22-top-25_{video}_gpt4_scaled_best_"
     "object_dinopose_layer_22_bbext_0.05_depth_zoedepth.csv"),
    ("Ours fine", "{video}-tracked.csv"),
]


def load_track(csv_path: Path):
    results = read_results_csv(csv_path, t_scale=1.0)  # video CSVs: metres
    results.sort(key=lambda r: r.im_id)
    rs = np.stack([r.R for r in results])
    ts = np.stack([r.t for r in results])
    scale = float(results[0].scale) if results else 1.0
    # Patch non-finite poses from neighbours (reference eval_videos.py:93-113).
    bad = ~(np.isfinite(rs).all(axis=(1, 2)) & np.isfinite(ts).all(axis=1))
    for i in np.nonzero(bad)[0]:
        j = i - 1
        while j >= 0 and bad[j]:
            j -= 1
        if j < 0:
            j = i + 1
            while j < len(rs) and bad[j]:
                j += 1
        if 0 <= j < len(rs):
            rs[i], ts[i] = rs[j], ts[j]
    return rs, ts, scale


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt-dir", required=True, help="dir of {video}_poses_id{n}.npy GT files")
    ap.add_argument("--results-dir", required=True)
    ap.add_argument("--methods", nargs="+", default=None,
                    help="name=pattern pairs; pattern contains {video} "
                    "(default: the paper's 6 comparison methods, reference "
                    "eval_videos.py:240-256)")
    ap.add_argument("--videos", nargs="*", default=None,
                    help="video names (default: the canonical 32-video set, "
                    "reference eval_videos.py:118-151)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)

    gt_files = sorted(Path(args.gt_dir).glob("*_poses_id*.npy"))
    # Default to the canonical 32-video benchmark set, restricted to videos
    # with GT on disk (the reference asserts all 32 exist; a partial GT tree
    # evaluates its subset).
    if args.videos:
        videos = args.videos
    else:
        on_disk = {f.name.split("_poses_id")[0] for f in gt_files}
        videos = [v for v in DEFAULT_VIDEOS if v in on_disk] or sorted(on_disk)
    if args.methods:
        methods = [tuple(s.split("=", 1)) for s in args.methods]
    else:
        methods = DEFAULT_METHODS

    tables = {m: {"rot": {}, "proj": {}, "depth": {}} for m in [n for n, _ in methods]}
    for name, pattern in methods:
        for video in videos:
            gt_matches = [f for f in gt_files if f.name.startswith(video + "_poses_id")]
            if not gt_matches:
                continue
            gt = np.load(gt_matches[0], allow_pickle=True).item()
            gt_poses = np.asarray(gt["poses"])
            gt_r, gt_t = gt_poses[:, :3, :3], gt_poses[:, :3, 3]
            sym_axis = gt.get("sym_axis")
            csv_path = Path(args.results_dir) / pattern.format(video=video)
            if not csv_path.exists():
                print(f"missing {csv_path}")
                continue
            est_r, est_t, est_scale = load_track(csv_path)
            n = min(len(est_r), len(gt_r))
            est_r, est_t, gt_r_, gt_t_ = est_r[:n], est_t[:n], gt_r[:n], gt_t[:n]
            dts = vm.default_dts(n)
            tables[name]["rot"][video] = np.rad2deg(
                vm.average_rot_errors_dt(est_r, gt_r_, dts, sym_axis=sym_axis)
            )
            tables[name]["proj"][video] = vm.average_proj_errors_dt(
                est_r, est_t, gt_t_, est_scale, dts, args.width, args.height
            )
            tables[name]["depth"][video] = vm.average_depth_errors_dt(
                est_r, est_t, gt_t_, est_scale, GT_SCALE, dts
            )

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    means = {}
    for metric in ("rot", "proj", "depth"):
        df = pd.DataFrame({m: tables[m][metric] for m in tables})
        df.to_csv(out_dir / f"results_{metric}.csv")
        means[metric] = df.mean()
        print(f"--- {metric} drift ---\n{df}\n")
    pd.DataFrame(means).to_csv(out_dir / "results_mean.csv")
    print(f"--- means ---\n{pd.DataFrame(means)}")


if __name__ == "__main__":
    main()
