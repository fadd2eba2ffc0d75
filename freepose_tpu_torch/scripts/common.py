"""Shared CLI plumbing for the port's entry points: device and shard args,
filelists, artifact names, model configs and loaders. Counterpart of the JAX
package's scripts/common.py; the --weights files are the same flat .npz of
JAX-layout params."""
from __future__ import annotations

import argparse
import os
from pathlib import Path

from freepose_tpu_torch.models.convert import load_params


def proposals_filename(box_thresh, text_thresh, feature_type, layer, topk, dataset_name) -> str:
    """The proposal JSON's name, from its settings (the reference's name
    template, so artifacts interoperate)."""
    return (
        f"props-ground-box-{box_thresh}-text-{text_thresh}-{feature_type}-{layer}"
        f"-top-{topk}_{dataset_name}.json"
    )


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass 'cpu' to run on the host)")


def full_fp32() -> None:
    """Run fp32 matrix products and convolutions in full fp32, as the JAX
    models do: cuDNN's fp32 convolutions default to TF32 (about 3 decimal
    digits), and ZoeDepth's DPT neck is mostly convolutions."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def tiny_sam2_video_config():
    """The tiny SAM2 video config of the JAX package's video tests (hidden
    128, 64² frames, a 4x4 memory grid), the port's own copy."""
    from freepose_tpu_torch.models.sam2.hiera import HieraConfig
    from freepose_tpu_torch.models.sam2.mask_decoder import MaskDecoderConfig
    from freepose_tpu_torch.models.sam2.memory import MemoryConfig
    from freepose_tpu_torch.models.sam2.model import Sam2Config
    from freepose_tpu_torch.models.sam2.prompt import PromptConfig
    from freepose_tpu_torch.models.sam2.video import Sam2VideoConfig

    d, grid, img = 128, 4, 64
    return Sam2VideoConfig(
        sam=Sam2Config(
            hiera=HieraConfig(
                embed_dim=8, blocks_per_stage=(1, 1, 1, 1), embed_dim_per_stage=(8, 16, 32, 64),
                heads_per_stage=(1, 2, 4, 8), window_size_per_stage=(4, 4, 4, 4),
                global_attention_blocks=(9,), window_pos_bg_size=(2, 2),
            ),
            prompt=PromptConfig(hidden_size=d, image_size=img, patch_size=16, mask_input_channels=16),
            decoder=MaskDecoderConfig(hidden_size=d, num_heads=2, mlp_dim=32, iou_head_hidden=d),
            fpn_dim=d,
        ),
        mem=MemoryConfig(hidden_size=d, num_layers=2, num_heads=1, downsample_rate=1, ff_hidden=32,
                         rope_feat_size=grid, mem_dim=64, enc_hidden=d, fuser_intermediate=32),
        image_size=img,
        mem_grid=grid,
    )


def production_sam2_config(device=None):
    """SAM2 Hiera-L image config at the production dtype. On the card: bf16
    trunk, neck, prompt encoder and decoder, with the global-attention blocks
    on kernel K2. On the CPU: fp32 and plain attention.
    FREEPOSE_TINY_MODELS=1 swaps in SAM2_TEST at 64². Returns (config,
    image_size)."""
    import dataclasses

    import torch

    from freepose_tpu_torch.device import resolve_device
    from freepose_tpu_torch.models.sam2.model import SAM2_TEST, Sam2Config

    if os.environ.get("FREEPOSE_TINY_MODELS"):
        return SAM2_TEST, 64
    cfg = Sam2Config()
    if resolve_device(device).type == "cuda":
        bf = torch.bfloat16
        cfg = dataclasses.replace(
            cfg, dtype=bf,
            hiera=dataclasses.replace(cfg.hiera, dtype=bf, use_flash=True),
            prompt=dataclasses.replace(cfg.prompt, dtype=bf),
            decoder=dataclasses.replace(cfg.decoder, dtype=bf),
        )
    return cfg, 1024


def production_sam2_video_config(device=None):
    """SAM2 video-tracking config at the production dtype: on the card the
    bf16 image model of `production_sam2_config` and bf16 memory attention
    and encoder, with memory self-attention on kernel K2 and the masked
    cross-attention on kernel K4; fp32 and plain attention on the CPU.
    FREEPOSE_TINY_MODELS=1 swaps in `tiny_sam2_video_config`."""
    import dataclasses

    import torch

    from freepose_tpu_torch.device import resolve_device
    from freepose_tpu_torch.models.sam2.video import Sam2VideoConfig

    if os.environ.get("FREEPOSE_TINY_MODELS"):
        return tiny_sam2_video_config()
    cfg, _ = production_sam2_config(device)
    vcfg = Sam2VideoConfig(sam=cfg)
    if resolve_device(device).type == "cuda":
        vcfg = dataclasses.replace(vcfg, mem=dataclasses.replace(vcfg.mem, use_flash=True, dtype=torch.bfloat16))
    return vcfg


def production_gdino_config(device=None):
    """GroundingDINO-B config at the production dtype: on the card bf16 for
    the model, Swin and BERT; fp32 on the CPU. FREEPOSE_TINY_MODELS=1 swaps
    in GDINO_TEST."""
    import dataclasses

    import torch

    from freepose_tpu_torch.device import resolve_device
    from freepose_tpu_torch.models.grounding_dino import GDINO_TEST, GroundingDinoConfig

    if os.environ.get("FREEPOSE_TINY_MODELS"):
        return GDINO_TEST
    cfg = GroundingDinoConfig()
    if resolve_device(device).type == "cuda":
        bf = torch.bfloat16
        cfg = dataclasses.replace(cfg, dtype=bf, swin=dataclasses.replace(cfg.swin, dtype=bf),
                                  text=dataclasses.replace(cfg.text, dtype=bf))
    return cfg


_MODELS: dict = {}


def _cached(key: tuple, build):
    """One model per (kind, weights, device, config) for the process, as
    the JAX CLIs keep theirs."""
    if key not in _MODELS:
        _MODELS[key] = build()
    return _MODELS[key]


def load_grounding_detector(weights: str | None, device=None):
    """GroundingDinoDetector at `production_gdino_config` on `device`, from
    a .npz of JAX-layout params or seeded random weights; cached."""
    from freepose_tpu_torch.device import resolve_device
    from freepose_tpu_torch.models.grounding_dino import GroundingDinoDetector

    dev, cfg = resolve_device(device), production_gdino_config(device)
    return _cached(("grounding", weights, str(dev), cfg),
                   lambda: GroundingDinoDetector.from_weights(weights, config=cfg, device=dev))


def load_sam2_image_predictor(weights: str | None, device=None):
    """Sam2ImagePredictor at `production_sam2_config` on `device`, from a
    .npz of JAX-layout params or seeded random weights; cached."""
    from freepose_tpu_torch.device import resolve_device
    from freepose_tpu_torch.models.sam2.predictor import Sam2ImagePredictor

    dev = resolve_device(device)
    cfg, size = production_sam2_config(device)
    return _cached(("sam2", weights, str(dev), cfg),
                   lambda: Sam2ImagePredictor(cfg, load_params(weights) if weights else None, image_size=size,
                                              device=dev))


def release_models() -> None:
    """Drop the cached detector and SAM2 predictor."""
    _MODELS.clear()
