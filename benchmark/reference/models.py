"""The reference's models: the frozen copies at float32 (TF32 off), with
the benchmark's weights."""
from __future__ import annotations

import torch

from benchmark import configs_build, synth, weights
from benchmark.reference.frozen.dinov2 import DinoV2, normalize_images, split_tokens
from benchmark.reference.frozen.sam2.video import Sam2VideoModel


def full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def spec_sam2(cfg: dict) -> Sam2VideoModel:
    """The SAM2 video model of `cfg` on the meta device: the weights' spec."""
    with torch.device("meta"):
        return Sam2VideoModel(configs_build.sam2_video_config(cfg, configs_build.FROZEN, torch.float32, False))


def spec_dinov2(cfg: dict, key: str) -> DinoV2:
    with torch.device("meta"):
        return DinoV2(configs_build.dinov2_config(cfg, key, configs_build.FROZEN, torch.float32))


def sam2(cfg: dict, seed: int, device) -> Sam2VideoModel:
    model = Sam2VideoModel(configs_build.sam2_video_config(cfg, configs_build.FROZEN, torch.float32, False))
    model = model.to(device).eval()
    weights.load_into(model, weights.make_weights(spec_sam2(cfg), synth.sub_seed(seed, "sam2"), device,
                                                  configs_build.served_dtype(cfg)))
    return model


def dinov2(cfg: dict, key: str, seed: int, device) -> DinoV2:
    model = DinoV2(configs_build.dinov2_config(cfg, key, configs_build.FROZEN, torch.float32)).to(device).eval()
    weights.load_into(model, weights.make_weights(spec_dinov2(cfg, key), synth.sub_seed(seed, key), device,
                                                  configs_build.served_dtype(cfg)))
    return model


@torch.inference_mode()
def patch_features(model: DinoV2, images: torch.Tensor, layer: int | None, batch: int = 32) -> torch.Tensor:
    """[B, 3, R, R] in [0, 1] -> [B, G², D] float32 patch tokens, normalized
    to unit length, `batch` images at a time."""
    out = []
    for i in range(0, images.shape[0], batch):
        tokens = model(normalize_images(images[i:i + batch].float()), layer=layer)
        f = split_tokens(tokens, model.config.num_registers)["patch"].float()
        out.append(f / torch.linalg.norm(f, dim=-1, keepdim=True).clamp(min=1e-12))
    return torch.cat(out)
