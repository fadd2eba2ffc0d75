"""Precompute monocular metric depth for BOP scenes (16-bit normalised PNGs).

Runs ZoeD_N (fp32; the BEiT trunk's attention on kernel K5 on the card) on
each RGB frame of the shard and writes depth_pred/<frame>.png next to rgb/,
depth / max_depth scaled to uint16 (read back as value / (2^16 - 1)).
Frames whose PNG exists are skipped. Counterpart of the JAX package's
scripts/generate_depth_zoe.py, with its flags and output, plus --device.

Usage: python -m freepose_tpu_torch.scripts.generate_depth_zoe --dataset BOP_ROOT \
         [--weights zoed.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from freepose_tpu_torch.datasets.bop import BOPDataset
from freepose_tpu_torch.scripts.common import add_device_arg, add_shard_args, full_fp32, get_shard


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--weights", default=None, help="converted depth-model params (.npz)")
    ap.add_argument("--max-depth", type=float, default=10.0)
    add_shard_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_fp32()  # the JAX model is fp32: no TF32 products or convolutions

    from PIL import Image

    from freepose_tpu_torch.models.zoedepth import MetricDepthEstimator

    est = MetricDepthEstimator.from_weights(args.weights, device=args.device)
    dataset = BOPDataset(args.dataset, args.split)
    for idx in get_shard(args).slice(len(dataset)):
        meta = dataset.frames[idx]
        out_path = Path(meta["rgb_path"]).parent.parent / "depth_pred" / Path(meta["rgb_path"]).name
        if out_path.exists():
            continue
        out_path.parent.mkdir(exist_ok=True)
        depth = est.predict(dataset[idx]["image"])  # metres [H, W]
        norm = np.clip(depth / args.max_depth, 0, 1)
        Image.fromarray((norm * (2**16 - 1)).astype(np.uint16)).save(out_path)
        print(f"depth {out_path}")


if __name__ == "__main__":
    main()
