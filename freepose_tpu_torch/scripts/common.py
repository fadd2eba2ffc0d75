"""Shared CLI plumbing for the port's entry points: device and shard args,
filelists, DINOv2 loading. Counterpart of the JAX package's scripts/common.py;
the --weights files are the same flat .npz of JAX-layout params."""
from __future__ import annotations

import argparse
import os
from pathlib import Path

from freepose_tpu_torch.models.convert import load_params


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass 'cpu' to run on the host)")


def add_shard_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--shard-index", type=int, default=None, help="worker index (defaults to env)")
    ap.add_argument("--shard-count", type=int, default=None, help="worker count (defaults to env)")


def get_shard(args):
    from freepose_tpu_torch.parallel.scheduler import current_shard

    return current_shard(args.shard_index, args.shard_count)


def load_filelist(path: str | Path) -> list[str]:
    return [line.strip() for line in Path(path).read_text().splitlines() if line.strip()]


def load_dino_extractor(weights: str | None, model: str = "vitl", layer_default: int = 22,
                        device=None):
    """DINOv2 extractor on `device` (default cuda); random-init when no
    weights are given. FREEPOSE_TINY_MODELS=1 swaps in the tiny test config.
    On the card the production path is bf16, with every attention call on
    kernel K2; on the CPU it is fp32 with K2's plain version."""
    import dataclasses

    import torch

    from freepose_tpu_torch.device import resolve_device
    from freepose_tpu_torch.models.dinov2 import (
        VIT_B14_REG,
        VIT_L14_REG,
        VIT_TEST,
        DinoFeatureExtractor,
    )

    dev = resolve_device(device)
    if os.environ.get("FREEPOSE_TINY_MODELS"):
        cfg = VIT_TEST
    else:
        cfg = {"vitl": VIT_L14_REG, "vitb": VIT_B14_REG}[model]
        if dev.type == "cuda":
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = load_params(weights) if weights else None
    return DinoFeatureExtractor(cfg, params=params, device=dev)
