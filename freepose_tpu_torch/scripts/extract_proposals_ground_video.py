"""Video proposals: boxes on frame 0, SAM2 mask propagation, retrieval.

Counterpart of the JAX package's scripts/extract_proposals_ground_video.py,
with the same arguments and the same proposal JSON: frame-0 boxes (from
GroundingDINO-B, `--detector grounding`, the default, or given with
`--detector boxes`) -> SAM2 Hiera-L video mask propagation over all frames
(all objects batched; on the card the attention runs on kernels K2 and K4)
-> per tracked mask a crop, DINOv2-L patch features (kernel K2) and FFA
pooling, scored against the mesh bank -> temporal soft voting (the mean of
per-frame bank scores per track) -> one mesh id per track.

`--shard-objects` joins the process group the FREEPOSE_* environment
describes (parallel/mesh.py:maybe_initialize_distributed) and splits SAM2's
objects over every card on the mesh's "data" axis (one shard on one card
or under --device cpu).

Usage: python -m freepose_tpu_torch.scripts.extract_proposals_ground_video \
         --video-dir FRAMES --bank bank.npy --filelist meshes.txt --out props.json \
         [--detector boxes --boxes boxes.npy] [--grounding-weights gd.npz] \
         [--sam2-weights sam2.npz] [--weights dinov2.npz] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from freepose_tpu_torch.datasets.video import load_frame_dir
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.io.proposals_json import proposal_entry, save_proposals
from freepose_tpu_torch.ops.sampling import ffa_pool
from freepose_tpu_torch.pipeline.proposals import extract_proposals
from freepose_tpu_torch.scripts.common import (
    add_device_arg,
    add_shard_args,
    load_dino_extractor,
    load_filelist,
    load_grounding_detector,
    load_params,
    production_sam2_video_config,
)


def load_video_predictor(sam2_weights: str | None, device=None, device_mesh=None):
    """Sam2VideoPredictor at the production config on `device` (with
    `device_mesh`, its objects split over the mesh's "data" axis); seeded
    random weights when no .npz of JAX-layout params is given."""
    from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor

    params = load_params(sam2_weights) if sam2_weights else None
    return Sam2VideoPredictor(production_sam2_video_config(device), params, device=device, device_mesh=device_mesh)


def retrieve_frame(extractor, bank: torch.Tensor, frame: np.ndarray, masks: np.ndarray, layer: int,
                   min_mask_px: int) -> list[tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Score one frame's tracked masks [N, H, W] bool against the
    L2-normalised bank [M, D]: per mask of at least `min_mask_px` pixels, a
    420² crop, DINOv2 patch features at `layer`, FFA pooling and the bank
    scores. Returns (track, mask, bbox xyxy, scores [M]) tuples."""
    dev = extractor.device
    frame_dev = torch.as_tensor(frame, device=dev)
    out = []
    for oi, m in enumerate(masks):
        if m.sum() < min_mask_px:
            continue
        m_dev = torch.as_tensor(m, device=dev)
        bbox = mask_to_bbox(m_dev)
        prop = extract_proposals(frame_dev, m_dev[None], bbox[None].float(), target_size=420, bbox_extend=0.1)
        patch = extractor(prop.proposals, layer=layer, feature_type="patch")
        feat = ffa_pool(patch.float(), prop.masks, grid=30)
        out.append((oi, m, bbox.cpu().numpy(), (feat @ bank.T)[0].cpu().numpy()))
    return out


def track_and_retrieve(predictor, frames: np.ndarray, boxes0: np.ndarray, extractor, bank: torch.Tensor,
                       layer: int, min_mask_px: int):
    """Propagate the frame-0 boxes through the video and score each tracked
    mask against the L2-normalised bank [M, D]. Returns (per-track lists of
    per-frame score vectors, {(t, track): mask}, {(t, track): bbox})."""
    state = predictor.init_state(frames)
    for i, box in enumerate(boxes0):
        state = predictor.add_new_points_or_box(state, 0, obj_id=i, box=np.asarray(box))
    per_track_scores: dict[int, list] = {i: [] for i in range(len(boxes0))}
    track_masks: dict[tuple, np.ndarray] = {}
    track_boxes: dict[tuple, np.ndarray] = {}
    for t, obj_ids, _, masks in predictor.propagate_in_video(state, binarize=True):
        for oi, m, bbox, scores in retrieve_frame(extractor, bank, frames[t], masks, layer, min_mask_px):
            track_masks[(t, oi)] = m
            track_boxes[(t, oi)] = bbox
            per_track_scores[oi].append(scores)
        print(f"frame {t}: {len(obj_ids)} objects tracked")
    return per_track_scores, track_masks, track_boxes


def soft_vote(per_track_scores, track_masks, track_boxes, names: list[str]) -> list[dict]:
    """Temporal soft voting: the mean of per-frame bank scores picks one mesh
    per track; every tracked frame of the track becomes a proposal."""
    out = []
    for oi, score_list in per_track_scores.items():
        if not score_list:
            continue
        mean_scores = np.mean(score_list, axis=0)
        best = int(np.argmax(mean_scores))
        for (t, o), m in track_masks.items():
            if o != oi:
                continue
            entry = proposal_entry(track_boxes[(t, o)], m, names[best], float(mean_scores[best]), 0, t)
            entry["track_id"] = oi
            out.append(entry)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--bank", required=True)
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--detector", choices=["grounding", "boxes"], default="grounding")
    ap.add_argument("--boxes", default=None, help="frame-0 boxes .npy [N, 4] xyxy (detector=boxes)")
    ap.add_argument("--text-prompt", default="objects.")
    ap.add_argument("--box-threshold", type=float, default=0.15)
    ap.add_argument("--text-threshold", type=float, default=0.15)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--sam2-weights", default=None)
    ap.add_argument("--grounding-weights", default=None)
    ap.add_argument("--layer", type=int, default=22)
    ap.add_argument("--min-mask-px", type=int, default=400)
    ap.add_argument("--shard-objects", action="store_true",
                    help="split SAM2 mask propagation's objects over every card (the mesh's data axis). One "
                         "host thread launches every shard's work in turn; not yet timed across cards")
    add_shard_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device_mesh = None
    if args.shard_objects:
        from freepose_tpu_torch.device import resolve_device
        from freepose_tpu_torch.parallel.mesh import cards_mesh, maybe_initialize_distributed

        maybe_initialize_distributed()
        device_mesh = cards_mesh(resolve_device(args.device), "data")

    frames = load_frame_dir(args.video_dir)
    if args.detector == "boxes":
        boxes0 = np.load(args.boxes).reshape(-1, 4)
    else:
        boxes0, _ = load_grounding_detector(args.grounding_weights, args.device).detect(
            frames[0], text=args.text_prompt, box_threshold=args.box_threshold, text_threshold=args.text_threshold)
    if len(boxes0) == 0:
        save_proposals([], args.out)
        print("no detections on frame 0")
        return

    predictor = load_video_predictor(args.sam2_weights, device=args.device, device_mesh=device_mesh)
    names = load_filelist(args.filelist)
    bank = np.load(args.bank).astype(np.float32)
    bank /= np.maximum(np.linalg.norm(bank, axis=-1, keepdims=True), 1e-12)
    extractor = load_dino_extractor(args.weights, device=args.device)
    scores, masks, boxes = track_and_retrieve(predictor, frames, boxes0, extractor,
                                              torch.as_tensor(bank, device=extractor.device), args.layer,
                                              args.min_mask_px)
    out = soft_vote(scores, masks, boxes, names)
    save_proposals(out, args.out)
    print(f"{len(out)} proposals ({len(scores)} tracks) -> {args.out}")


if __name__ == "__main__":
    main()
