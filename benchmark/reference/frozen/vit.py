"""Shared ViT building blocks as nn.Modules (DINOv2), counterparts of
freepose_tpu.models.vit. Inference only: no dropout.

Module and parameter names follow the JAX package's parameter tree (qkv,
proj, fc1, fc2, norm1, norm2, ls1.gamma, ls2.gamma) so
models/convert.py:dinov2_from_jax maps one onto the other directly.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.frozen.attention import flash_attention_fn


class MultiHeadAttention(nn.Module):
    """q/k/v are laid out [B, H, N, d] for `attention_fn` (default: K2 on the
    card, its plain version on the CPU)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, attention_fn: Optional[Callable] = None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)
        self.attention_fn = attention_fn or flash_attention_fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        head_dim = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4).contiguous()  # [3, B, H, N, d]
        out = self.attention_fn(qkv[0], qkv[1], qkv[2], scale=head_dim**-0.5)
        out = out.transpose(1, 2).reshape(b, n, self.dim)
        return self.proj(out)


class Mlp(nn.Module):
    """fc1 -> GELU (tanh approximation, flax.linen.gelu's default) -> fc2."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class TransformerBlock(nn.Module):
    """Pre-norm ViT block with optional LayerScale (DINOv2-style)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, layerscale: bool = True,
                 dtype: torch.dtype = torch.float32, attention_fn: Optional[Callable] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = MultiHeadAttention(dim, num_heads, dtype=dtype, attention_fn=attention_fn)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.ls1 = LayerScale(dim, dtype=dtype) if layerscale else nn.Identity()
        self.ls2 = LayerScale(dim, dtype=dtype) if layerscale else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: tuple[int, int], src_grid: int) -> torch.Tensor:
    """Bicubic-resample [1, src*src, D] patch position embeddings to a new
    (h, w) patch grid. antialias=True selects the Keys cubic with a = -0.5
    and half-pixel centres, the kernel of jax.image.resize("bicubic");
    torch's non-antialiased bicubic uses a = -0.75 and would not match."""
    h, w = grid_hw
    if (h, w) == (src_grid, src_grid):
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed.reshape(1, src_grid, src_grid, d).permute(0, 3, 1, 2)
    resized = F.interpolate(grid, size=(h, w), mode="bicubic", antialias=True, align_corners=False)
    return resized.permute(0, 2, 3, 1).reshape(1, h * w, d)
