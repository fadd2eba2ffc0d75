"""Metric scale estimation for video proposals (CLIP prior + depth median).

For each proposal of the video proposal JSON (`extract_proposals_ground_video`
writes it): CLIP ViT-bigG/14 embeds the crop and a kNN median (k = 11) over
the LLM prior's text embeddings gives a prior scale; with --depth-weights,
ZoeD_N predicts the frame's metric depth (the BEiT trunk's attention on
kernel K5 on the card) and `depth_scales` measures the mask's pointcloud.
Per track, the median prior/depth ratio corrects the depth scales, whose
median becomes the track's `scale`. Counterpart of the JAX package's
scripts/compute_scale_video.py, with its flags and output, plus --device.
Like it, depth runs once per proposal, not once per frame. fp32 throughout
(TF32 off).

Usage: python -m freepose_tpu_torch.scripts.compute_scale_video --video-dir FRAMES \
         --proposals props.json --scale-file prior.json [--depth-weights zoed.npz] \
         [--clip-weights clip.npz] [--bpe-vocab bpe.txt] [--device cpu]
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.video import load_frame_dir
from freepose_tpu_torch.geometry.camera import default_video_intrinsics
from freepose_tpu_torch.io.proposals_json import load_proposals, proposal_bbox_xyxy, proposal_mask, save_proposals
from freepose_tpu_torch.pipeline.proposals import extract_proposals
from freepose_tpu_torch.pipeline.scale_estimator import ClipPriorScaleEstimator, depth_scales
from freepose_tpu_torch.scripts.common import add_device_arg, full_fp32
from freepose_tpu_torch.scripts.compute_scale import load_clip, make_tokenizer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--proposals", required=True)
    ap.add_argument("--scale-file", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--clip-weights", default=None)
    ap.add_argument("--depth-weights", default=None, help="metric depth params; omit to skip depth correction")
    ap.add_argument("--bpe-vocab", default=None)
    ap.add_argument("--query-k", type=int, default=11)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_fp32()  # the JAX models are fp32: no TF32 products or convolutions

    frames = load_frame_dir(args.video_dir)
    h, w = frames.shape[1:3]
    props = load_proposals(args.proposals)
    clip = load_clip(args.clip_weights, device=args.device)
    dev = clip.device
    k = default_video_intrinsics(w, h, device=dev)
    est = ClipPriorScaleEstimator(clip, make_tokenizer(args.bpe_vocab, clip.config), scale_file=args.scale_file,
                                  query_k=args.query_k)

    depth_est = None
    if args.depth_weights is not None:
        from freepose_tpu_torch.models.zoedepth import MetricDepthEstimator

        depth_est = MetricDepthEstimator.from_weights(args.depth_weights, device=dev)

    per_object: dict = defaultdict(list)
    for p in props:
        f = p["image_id"]
        mask = torch.as_tensor(proposal_mask(p), device=dev)
        bbox = torch.as_tensor(proposal_bbox_xyxy(p).astype(np.float32), device=dev)
        prop = extract_proposals(torch.as_tensor(frames[f], device=dev), mask[None], bbox[None],
                                 target_size=clip.config.image_size, bbox_extend=0.0)
        prior = float(est.estimate(prop)[0])
        d_scale = None
        if depth_est is not None:
            depth = torch.as_tensor(depth_est.predict(frames[f]), device=dev)
            d_scale = float(depth_scales(depth, k, mask[None])[0])
        # Per-frame prior/depth pairing; median correction over the track.
        per_object[p.get("track_id", p["mesh"])].append((prior, d_scale))

    scale_per_object = {}
    for key, pairs in per_object.items():
        priors = np.array([a for a, _ in pairs])
        if pairs[0][1] is not None:
            depths = np.array([d for _, d in pairs])
            corr = np.median(priors / np.maximum(depths, 1e-9))
            scale_per_object[key] = float(np.median(depths * corr))
        else:
            scale_per_object[key] = float(np.median(priors))

    for p in props:
        p["scale"] = scale_per_object[p.get("track_id", p["mesh"])]
    out = args.out or str(Path(args.proposals).with_suffix("")) + "_gpt4_scaled.json"
    save_proposals(props, out)
    print(f"scaled video proposals -> {out}")


if __name__ == "__main__":
    main()
