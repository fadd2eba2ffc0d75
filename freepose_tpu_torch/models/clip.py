"""CLIP image and text towers as nn.Modules.

Counterpart of freepose_tpu.models.clip: the CLIP ViT-bigG/14 extractor of
the scale stage (image embeddings of the proposals, text embeddings of the
2,201 LLM scale-prior names). Pre-LN ViT with a class token and learned
positions; a causal text transformer pooled at EOT (the highest id).
Attention is the plain einsum and softmax of the JAX model, which has no
Pallas kernel here. Names follow the JAX tree
(models/convert.py:clip_from_jax unstacks its scanned layers).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.models.layers import Dense, LayerNorm

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    # vision
    image_size: int = 224
    patch_size: int = 14
    vision_width: int = 1664
    vision_layers: int = 48
    vision_heads: int = 16
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 1280
    text_layers: int = 32
    text_heads: int = 20
    # joint
    embed_dim: int = 1280
    mlp_ratio: float = 4.0
    quick_gelu: bool = False  # bigG uses plain GELU; OpenAI ViT-L uses quick
    dtype: torch.dtype = torch.float32


VIT_BIGG_14 = ClipConfig()
CLIP_TEST = ClipConfig(
    image_size=28, patch_size=14, vision_width=32, vision_layers=2, vision_heads=2,
    vocab_size=64, context_length=12, text_width=24, text_layers=2, text_heads=2,
    embed_dim=16,
)


class ClipEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float, quick_gelu: bool, dtype: torch.dtype):
        super().__init__()
        self.width, self.heads, self.quick_gelu = width, heads, quick_gelu
        self.ln1 = LayerNorm(width, eps=1e-5, dtype=dtype)
        self.qkv = Dense(width, 3 * width, dtype=dtype)
        self.proj = Dense(width, width, dtype=dtype)
        self.ln2 = LayerNorm(width, eps=1e-5, dtype=dtype)
        self.fc1 = Dense(width, int(width * mlp_ratio), dtype=dtype)
        self.fc2 = Dense(int(width * mlp_ratio), width, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        head_dim = self.width // self.heads
        qkv = self.qkv(self.ln1(x)).reshape(b, n, 3, self.heads, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * (head_dim**-0.5)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bhnm,bhmd->bhnd", w, v).transpose(1, 2).reshape(b, n, self.width)
        x = x + self.proj(attn)
        h = self.fc1(self.ln2(x))
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return x + self.fc2(h)


class ClipVisionTower(nn.Module):
    def __init__(self, config: ClipConfig):
        super().__init__()
        c = self.config = config
        w = c.vision_width
        self.patch_embed = nn.Conv2d(3, w, c.patch_size, stride=c.patch_size, bias=False, dtype=c.dtype)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.pos_embed = nn.Parameter(torch.zeros((c.image_size // c.patch_size) ** 2 + 1, w))
        self.ln_pre = LayerNorm(w, eps=1e-5, dtype=c.dtype)
        self.layers = nn.ModuleList(ClipEncoderLayer(w, c.vision_heads, c.mlp_ratio, c.quick_gelu, c.dtype)
                                    for _ in range(c.vision_layers))
        self.ln_post = LayerNorm(w, eps=1e-5, dtype=c.dtype)
        self.proj = nn.Parameter(torch.zeros(w, c.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] CLIP-normalised -> [B, embed_dim] image features."""
        c = self.config
        b = images.shape[0]
        x = self.patch_embed(images.to(c.dtype)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(c.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed[None].to(c.dtype)
        x = self.ln_pre(x)
        for layer in self.layers:
            x = layer(x)
        return self.ln_post(x[:, 0]) @ self.proj.to(c.dtype)


class ClipTextTower(nn.Module):
    def __init__(self, config: ClipConfig):
        super().__init__()
        c = self.config = config
        w = c.text_width
        self.token_embedding = nn.Parameter(torch.zeros(c.vocab_size, w))
        self.pos_embed = nn.Parameter(torch.zeros(c.context_length, w))
        self.layers = nn.ModuleList(ClipEncoderLayer(w, c.text_heads, c.mlp_ratio, c.quick_gelu, c.dtype)
                                    for _ in range(c.text_layers))
        self.ln_final = LayerNorm(w, eps=1e-5, dtype=c.dtype)
        self.text_proj = nn.Parameter(torch.zeros(w, c.embed_dim))

    def forward(self, input_ids: torch.Tensor, eot_positions: torch.Tensor | None = None) -> torch.Tensor:
        """[B, L] token ids -> [B, embed_dim] text features pooled at EOT
        (default: the argmax of the ids, CLIP's EOT having the highest id)."""
        c = self.config
        b, length = input_ids.shape
        ids = input_ids.long()
        x = self.token_embedding[ids].to(c.dtype) + self.pos_embed[None, :length].to(c.dtype)
        causal = torch.triu(torch.full((length, length), -torch.inf, device=x.device), diagonal=1)
        for layer in self.layers:
            x = layer(x, mask=causal[None, None])
        x = self.ln_final(x)
        if eot_positions is None:
            eot_positions = torch.argmax(ids, dim=-1)
        pooled = x[torch.arange(b, device=x.device), eot_positions]
        return pooled @ self.text_proj.to(c.dtype)


class Clip(nn.Module):
    def __init__(self, config: ClipConfig):
        super().__init__()
        self.config = config
        self.visual = ClipVisionTower(config)
        self.text = ClipTextTower(config)


def clip_normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> CLIP-normalised."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
    return (images - mean) / std


def init_random(model: Clip, seed: int) -> None:
    """Seeded random weights drawn on the model's device (bigG holds ~2.5 B
    parameters, ~10 GB in fp32: no host copy): lecun-normal Dense and conv
    kernels, zero biases, unit LayerNorms, N(0, 0.02) embeddings and
    projections (text positions N(0, 0.01)), as the JAX initialisers."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for tower in (model.visual, model.text):
            for name, p in tower.named_parameters(recurse=False):
                p.normal_(0.0, 0.01 if (tower is model.text and name == "pos_embed") else 0.02, generator=gen)


class ClipFeatureExtractor:
    """Image/text embedding front end on `device` (default cuda). params: the
    JAX package's Clip parameter tree (nested numpy), or None for seeded
    random weights drawn on the device (`init_random`)."""

    def __init__(self, config: ClipConfig = VIT_BIGG_14, params=None, seed: int = 0, device=None):
        from freepose_tpu_torch.models.convert import clip_from_jax

        self.config = config
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = Clip(config)
        model.to_empty(device=self.device)
        if params is None:
            init_random(model, seed)
        else:
            model.load_state_dict(clip_from_jax(params))
        self.model = model.eval()

    @torch.inference_mode()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [0, 1] -> [B, embed_dim]."""
        images = torch.as_tensor(images, device=self.device)
        return self.model.visual(clip_normalize_images(images.to(self.config.dtype)))

    @torch.inference_mode()
    def encode_text(self, input_ids) -> torch.Tensor:
        """[B, L] int token ids (numpy or torch) -> [B, embed_dim]."""
        return self.model.text(torch.as_tensor(input_ids, device=self.device))
