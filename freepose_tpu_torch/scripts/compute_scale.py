"""Metric scale estimation for proposals (static datasets).

CLIP-embed each proposal crop, kNN-median against the LLM text-prior table
(gpt4/gpt35/gemma2/llama31 JSON), optionally depth-correct with the
dataset's depth_pred maps, and write `*_gpt4_scaled.json` proposals with a
`scale` field. Counterpart of the JAX package's scripts/compute_scale.py,
with its flags and output, plus --device. fp32 throughout (TF32 off).

Usage: python -m freepose_tpu_torch.scripts.compute_scale --dataset BOP_ROOT \
         --proposals props.json --scale-file prior.json [--use-depth] \
         [--clip-weights clip.npz] [--bpe-vocab bpe.txt] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.bop import BOPDataset
from freepose_tpu_torch.io.proposals_json import (
    filter_by_frame,
    load_proposals,
    proposal_bbox_xyxy,
    proposal_mask,
    save_proposals,
)
from freepose_tpu_torch.models.convert import load_params
from freepose_tpu_torch.pipeline.proposals import extract_proposals
from freepose_tpu_torch.pipeline.scale_estimator import ClipPriorScaleEstimator
from freepose_tpu_torch.scripts.common import add_device_arg, full_fp32


def load_clip(weights: str | None, device=None):
    """CLIP ViT-bigG/14 in fp32 on `device` (default cuda), random weights
    drawn on the device unless `weights` (a .npz of the JAX layout) is
    given; FREEPOSE_TINY_MODELS=1 takes CLIP_TEST."""
    from freepose_tpu_torch.models.clip import CLIP_TEST, VIT_BIGG_14, ClipFeatureExtractor

    cfg = CLIP_TEST if os.environ.get("FREEPOSE_TINY_MODELS") else VIT_BIGG_14
    return ClipFeatureExtractor(cfg, params=load_params(weights) if weights else None, device=device)


def simple_tokenizer(vocab_size: int, length: int):
    """Hash tokenizer for runs without a BPE vocabulary (deterministic within
    one process: Python's str hash is salted per process)."""

    def tok(names):
        out = np.zeros((len(names), length), np.int32)
        for i, n in enumerate(names):
            h = abs(hash(n))
            for j in range(length - 1):
                out[i, j] = 1 + (h >> (j * 3)) % (vocab_size - 2)
            out[i, length - 1] = vocab_size - 1
        return out

    return tok


def make_tokenizer(bpe_vocab: str | None, config):
    """The CLIP BPE tokenizer of `bpe_vocab`, else `simple_tokenizer`."""
    if bpe_vocab:
        from freepose_tpu_torch.models.tokenizer import ClipTokenizer

        return ClipTokenizer(bpe_vocab, context_length=config.context_length)
    return simple_tokenizer(config.vocab_size, config.context_length)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--proposals", required=True)
    ap.add_argument("--scale-file", required=True, help="LLM prior JSON (e.g. data/gpt4_scales.json)")
    ap.add_argument("--out", default=None, help="defaults to <proposals>_gpt4_scaled.json")
    ap.add_argument("--clip-weights", default=None)
    ap.add_argument("--bpe-vocab", default=None, help="CLIP BPE merges file")
    ap.add_argument("--query-k", type=int, default=11)
    ap.add_argument("--use-depth", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_fp32()  # the JAX models are fp32: no TF32 products or convolutions

    clip = load_clip(args.clip_weights, device=args.device)
    dev = clip.device
    tokenize = make_tokenizer(args.bpe_vocab, clip.config)
    est = ClipPriorScaleEstimator(clip, tokenize, scale_file=args.scale_file, query_k=args.query_k)
    dataset = BOPDataset(args.dataset, args.split)
    props = load_proposals(args.proposals)

    for idx in range(len(dataset)):
        entry = dataset[idx]
        frame_props = filter_by_frame(props, entry["scene_id"], entry["frame_id"])
        if not frame_props:
            continue
        masks = np.stack([proposal_mask(p) for p in frame_props])
        boxes = np.stack([proposal_bbox_xyxy(p) for p in frame_props]).astype(np.float32)
        prop = extract_proposals(
            torch.tensor(entry["image"], device=dev), torch.as_tensor(masks, device=dev),
            torch.as_tensor(boxes, device=dev), target_size=clip.config.image_size, bbox_extend=0.0,
        )
        depth = entry["depth_pred"] if args.use_depth else None
        k = entry["intrinsic"] if args.use_depth else None
        scales = est.estimate(prop, depth, k)
        for p, s in zip(frame_props, scales):
            p["scale"] = float(s)

    out = args.out or str(Path(args.proposals).with_suffix("")) + "_gpt4_scaled.json"
    save_proposals(props, out)
    print(f"scaled proposals -> {out}")


if __name__ == "__main__":
    main()
