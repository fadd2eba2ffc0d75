"""DINOv2 ViT with register tokens, as an nn.Module.

Counterpart of freepose_tpu.models.dinov2: ViT-L/14-reg for retrieval and
pose scoring (truncated at block 22 of 24), ViT-B/14-reg for the tracking
refiner. Tokens = [cls, reg×4, patches]; position embeddings cover cls and
patches only, bicubically resampled for non-native grids. The cls, register
and position tokens stay fp32 and are added before the cast to the compute
dtype, as in the JAX model; everything else runs in `config.dtype`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from freepose_tpu_torch.models.vit import TransformerBlock, interpolate_pos_embed

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 518  # native grid the position embeddings were trained at
    num_registers: int = 4
    mlp_ratio: float = 4.0
    dtype: torch.dtype = torch.float32

    @property
    def native_grid(self) -> int:
        return self.image_size // self.patch_size


VIT_L14_REG = DinoV2Config()
VIT_B14_REG = DinoV2Config(hidden_size=768, num_layers=12, num_heads=12)
VIT_S14_REG = DinoV2Config(hidden_size=384, num_layers=12, num_heads=6)
# Tiny config for tests.
VIT_TEST = DinoV2Config(hidden_size=64, num_layers=3, num_heads=4, image_size=56)


class DinoV2(nn.Module):
    """Returns all-token features after block `layer` + final norm. Only the
    first `layer` blocks run."""

    def __init__(self, config: DinoV2Config):
        super().__init__()
        cfg = self.config = config
        d = cfg.hidden_size
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, dtype=cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.reg_tokens = nn.Parameter(torch.zeros(1, cfg.num_registers, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.native_grid**2, d))
        self.blocks = nn.ModuleList(
            TransformerBlock(d, cfg.num_heads, cfg.mlp_ratio, layerscale=True, dtype=cfg.dtype)
            for _ in range(cfg.num_layers)
        )
        self.norm = nn.LayerNorm(d, eps=1e-6, dtype=cfg.dtype)

    def forward(self, images: torch.Tensor, layer: Optional[int] = None) -> torch.Tensor:
        """images: [B, 3, H, W], ImageNet-normalized. -> [B, 1+R+N, D]."""
        cfg = self.config
        n_layers = layer if layer is not None else cfg.num_layers
        b, _, h, w = images.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size

        x = self.patch_embed(images.to(cfg.dtype)).flatten(2).transpose(1, 2)  # [B, gh*gw, D]
        patch_pos = interpolate_pos_embed(self.pos_embed[:, 1:], (gh, gw), cfg.native_grid)
        x = x + patch_pos.to(cfg.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(cfg.dtype)
        x = torch.cat(
            [cls.expand(b, -1, -1), self.reg_tokens.to(cfg.dtype).expand(b, -1, -1), x], dim=1
        )
        for blk in self.blocks[:n_layers]:
            x = blk(x)
        return self.norm(x)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
    return (images - mean) / std


def split_tokens(tokens: torch.Tensor, num_registers: int = 4) -> dict:
    return {
        "cls": tokens[:, 0],
        "reg": tokens[:, 1 : 1 + num_registers],
        "patch": tokens[:, 1 + num_registers :],
    }


def init_random_(model: DinoV2, generator: torch.Generator) -> DinoV2:
    """Seeded random init in the JAX model's scheme: lecun-normal kernels,
    zero biases, unit LayerNorm, LayerScale 1e-5, pos_embed N(0, 0.02),
    zero cls/register tokens."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "pos_embed":
                vals = torch.randn(p.shape, generator=generator) * 0.02
            elif name in ("cls_token", "reg_tokens") or leaf == "bias":
                vals = torch.zeros(p.shape)
            elif leaf == "gamma":
                vals = torch.full(p.shape, 1e-5)
            elif p.ndim == 1:  # LayerNorm weight
                vals = torch.ones(p.shape)
            else:  # Linear [out, in] / Conv [out, in, kh, kw]
                fan_in = math.prod(p.shape[1:])
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            p.copy_(vals)
    return model


class DinoFeatureExtractor:
    """Feature-extraction front end: normalize, run to `layer`, final norm,
    select cls / reg / patch tokens.

    params: the JAX package's DINOv2 parameter tree (nested dicts of numpy
    arrays, as scripts' load_params returns), converted with
    models/convert.py:dinov2_from_jax; None gives a seeded random init.
    Runs on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: DinoV2Config = VIT_L14_REG, params=None, seed: int = 0,
                 device: str | torch.device | None = None):
        from freepose_tpu_torch.device import resolve_device

        self.config = config
        self.device = resolve_device(device)
        model = DinoV2(config)
        if params is None:
            init_random_(model, torch.Generator().manual_seed(seed))
        else:
            from freepose_tpu_torch.models.convert import dinov2_from_jax

            model.load_state_dict(dinov2_from_jax(params))
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, layer: int = 22, feature_type: str = "patch") -> torch.Tensor:
        images = images.to(self.device)
        tokens = self.model(normalize_images(images.to(self.config.dtype)), layer=layer)
        return split_tokens(tokens, self.config.num_registers)[feature_type]
