"""Semi-supervised VOS inference over a dataset tree (SA-V / DAVIS layout).

Counterpart of the JAX package's scripts/vos_inference.py, with the same
arguments (plus --device) and the same mask PNGs: SAM2 Hiera-L at 1024²
(bf16 on the card, its attention on kernels K2 at d 72 and 256 and K4;
fp32 with plain attention on the CPU), seeded random weights unless
--sam2-weights gives a .npz of JAX-layout params. The reference's vendored
SAM2 VOS runner
(segment-anything-2/tools/vos_inference.py): for each video under
--base-video-dir, seed the tracker with the GT mask(s) — multi-object
palette PNGs (pixel value = object id) or per-object `{obj:03d}/` PNG
subdirectories — propagate through the video with cross-object non-overlap
suppression, and write per-frame output masks in the same layout
(palette PNG or per-object trees). Each object is seeded ON ITS
FIRST-APPEARANCE FRAME (the reference's --track_object_appearing_later
behavior; our predictor conditions per-object prompt-frame groups
natively), with MASK prompts through the mask-as-output path
(reference sam2_video_predictor.py:309-378).

Optionally reports J&F per object against --gt-mask-dir.

Usage: python -m freepose_tpu_torch.scripts.vos_inference --base-video-dir VIDEOS \
         --input-mask-dir MASKS --output-mask-dir OUT [--use-all-masks] \
         [--per-obj-png-file] [--gt-mask-dir GT] [--sam2-weights sam2.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from freepose_tpu_torch.datasets.video import load_frame_dir
from freepose_tpu_torch.evaluation.vos_metrics import track_j_and_f
from freepose_tpu_torch.scripts.common import add_device_arg


def davis_palette() -> bytes:
    """Standard VOC/DAVIS 256-color palette (bit-shuffle colormap; the same
    bytes the reference embeds as DAVIS_PALETTE)."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        v, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((v >> 0) & 1) << (7 - j)
            g |= ((v >> 1) & 1) << (7 - j)
            b |= ((v >> 2) & 1) << (7 - j)
            v >>= 3
        pal[i] = (r, g, b)
    return pal.tobytes()


def load_ann_png(path: Path):
    """Palette PNG -> (uint8 id mask, palette bytes or None)."""
    from PIL import Image

    img = Image.open(path)
    palette = img.getpalette()
    return np.array(img).astype(np.uint8), palette


def save_ann_png(path: Path, mask: np.ndarray, palette) -> None:
    from PIL import Image

    if mask.dtype != np.uint8 or mask.ndim != 2:
        raise ValueError(f"an id mask is 2-D uint8, got {mask.dtype} {mask.shape}")
    img = Image.fromarray(mask)
    img.putpalette(palette)
    img.save(path)


def get_per_obj_mask(mask: np.ndarray) -> dict[int, np.ndarray]:
    """Split an id mask into {obj_id: bool mask} (ids > 0)."""
    ids = np.unique(mask)
    return {int(i): mask == i for i in ids if i > 0}


def put_per_obj_mask(per_obj: dict[int, np.ndarray], h: int, w: int) -> np.ndarray:
    """Combine per-object masks into one id mask; on overlap the LOWEST id
    wins (reference paints ids in descending order)."""
    out = np.zeros((h, w), np.uint8)
    for obj_id in sorted(per_obj)[::-1]:
        out[per_obj[obj_id].reshape(h, w)] = obj_id
    return out


def list_frames(video_dir: Path) -> list[str]:
    names = [
        p.stem for p in video_dir.iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    ]
    try:
        names.sort(key=int)
    except ValueError:
        names.sort()
    return names


def load_video_masks(
    mask_dir: Path, video: str, frame_names: list[str], per_obj_png: bool,
    use_all: bool,
):
    """-> ({frame_idx: {obj_id: bool mask}}, palette). Default: frame 0 only;
    use_all: every frame with a mask file (objects appearing later seed at
    their first available mask)."""
    vdir = mask_dir / video
    palette = None
    frames_with_masks: dict[int, dict[int, np.ndarray]] = {}
    if per_obj_png:
        for obj_dir in sorted(p for p in vdir.iterdir() if p.is_dir()):
            obj_id = int(obj_dir.name)
            for idx, name in enumerate(frame_names):
                p = obj_dir / f"{name}.png"
                if p.exists() and (use_all or idx == 0):
                    m, palette = load_ann_png(p)
                    frames_with_masks.setdefault(idx, {})[obj_id] = m > 0
    else:
        idxs = range(len(frame_names)) if use_all else [0]
        for idx in idxs:
            p = vdir / f"{frame_names[idx]}.png"
            if p.exists():
                m, palette = load_ann_png(p)
                frames_with_masks[idx] = get_per_obj_mask(m)
    return frames_with_masks, palette


def run_video(args, predictor, video: str) -> dict:
    video_dir = Path(args.base_video_dir) / video
    frame_names = list_frames(video_dir)
    frames = load_frame_dir(video_dir)
    h, w = frames.shape[1], frames.shape[2]

    input_masks, palette = load_video_masks(
        Path(args.input_mask_dir), video, frame_names,
        args.per_obj_png_file, args.use_all_masks,
    )
    if not input_masks:
        raise SystemExit(f"no input masks for video {video}")
    palette = palette or davis_palette()

    state = predictor.init_state(frames)
    seeded: set[int] = set()
    for idx in sorted(input_masks):
        for obj_id, m in sorted(input_masks[idx].items()):
            # Each object seeds at its FIRST available mask frame; later
            # masks of an already-seeded object re-prompt (replace) only
            # with --use-all-masks (correction semantics).
            if obj_id not in seeded or args.use_all_masks:
                state = predictor.add_new_mask(state, idx, obj_id, m)
                seeded.add(obj_id)

    out_dir = Path(args.output_mask_dir) / video
    out_dir.mkdir(parents=True, exist_ok=True)
    binarize = args.score_thresh == 0.0
    per_frame: dict[int, dict[int, np.ndarray]] = {}
    for t, obj_ids, _, high in predictor.propagate_in_video(
        state, binarize=binarize, non_overlap_masks=True,
    ):
        masks = high if binarize else high > args.score_thresh
        per_frame[t] = {oid: masks[i] for i, oid in enumerate(obj_ids)}

    for t, per_obj in per_frame.items():
        if args.per_obj_png_file:
            for obj_id, m in per_obj.items():
                odir = out_dir / f"{obj_id:03d}"
                odir.mkdir(exist_ok=True)
                save_ann_png(
                    odir / f"{frame_names[t]}.png",
                    m.astype(np.uint8), palette,
                )
        else:
            save_ann_png(
                out_dir / f"{frame_names[t]}.png",
                put_per_obj_mask(per_obj, h, w), palette,
            )

    report = {"video": video, "frames": len(per_frame),
              "objects": sorted({o for d in per_frame.values() for o in d})}
    if args.gt_mask_dir:
        gt_dir = Path(args.gt_mask_dir) / video
        scores = {}
        ts = sorted(per_frame)
        gt_frames = [load_ann_png(gt_dir / f"{frame_names[t]}.png")[0] for t in ts]
        for obj_id in report["objects"]:
            pred = np.stack([per_frame[t][obj_id] for t in ts])
            gt = np.stack([g == obj_id for g in gt_frames])
            scores[obj_id] = track_j_and_f(pred, gt)
        report["per_object"] = scores
        report["J&F"] = float(
            np.mean([s["J&F"] for s in scores.values()])
        ) if scores else float("nan")
    return report


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-video-dir", required=True,
                    help="dir of {video}/ frame-image subdirectories")
    ap.add_argument("--input-mask-dir", required=True,
                    help="dir of {video}.png palette masks (or per-object trees)")
    ap.add_argument("--output-mask-dir", required=True)
    ap.add_argument("--video-names", nargs="*", default=None,
                    help="default: every subdirectory of --base-video-dir")
    ap.add_argument("--score-thresh", type=float, default=0.0)
    ap.add_argument("--use-all-masks", action="store_true",
                    help="seed from every available input mask frame, not "
                    "just frame 0 (objects appearing later always seed at "
                    "their first mask)")
    ap.add_argument("--per-obj-png-file", action="store_true",
                    help="masks stored per object as {video}/{obj:03d}/*.png")
    ap.add_argument("--gt-mask-dir", default=None,
                    help="GT palette masks for per-object J&F reporting")
    ap.add_argument("--sam2-weights", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from freepose_tpu_torch.scripts.extract_proposals_ground_video import load_video_predictor

    videos = args.video_names or sorted(
        p.name for p in Path(args.base_video_dir).iterdir() if p.is_dir()
    )
    predictor = load_video_predictor(args.sam2_weights, device=args.device)
    reports = []
    for video in videos:
        rep = run_video(args, predictor, video)
        reports.append(rep)
        print(json.dumps(rep))
    if args.gt_mask_dir and reports:
        mean = float(np.mean([r["J&F"] for r in reports if "J&F" in r]))
        print(json.dumps({"videos": len(reports), "mean J&F": mean}))
    return reports


if __name__ == "__main__":
    main()
