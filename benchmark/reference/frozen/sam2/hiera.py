"""Hiera trunk + FPN neck of SAM2, as nn.Modules.

Counterpart of freepose_tpu.models.sam2.hiera: a hierarchical ViT with
windowed attention, global attention at selected blocks, max-pool query
downsampling at stage changes, windowed position embeddings, and a top-down
FPN neck giving the 256-d feature pyramid with sine position encodings.
Activations are NHWC, as in the JAX package.

Windowed attention is a plain einsum, as in the JAX package. The global
blocks call `flash_attention_auto` when `use_flash` is set: kernel K2 on the
card (Hiera-L: [1, 8, 4096, 72]), its plain version on the CPU. The JAX
trunk keeps runs of same-window blocks partitioned to save TPU copies; the
numbers are the same as the per-block partition used here.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from benchmark.reference.frozen import attention
from benchmark.reference.frozen.layers import Conv, Dense, LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144  # hiera-large (sam2_hiera_l.yaml)
    blocks_per_stage: tuple = (2, 6, 36, 4)
    embed_dim_per_stage: tuple = (144, 288, 576, 1152)
    heads_per_stage: tuple = (2, 4, 8, 16)
    window_size_per_stage: tuple = (8, 4, 16, 8)
    global_attention_blocks: tuple = (23, 33, 43)
    window_pos_bg_size: tuple = (7, 7)
    query_stride: int = 2
    num_query_pool_stages: int = 3
    mlp_ratio: float = 4.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    dtype: torch.dtype = torch.float32
    use_flash: bool = False  # global-attention blocks through flash_attention_auto (K2)


HIERA_L = HieraConfig()
HIERA_TEST = HieraConfig(
    embed_dim=8,
    blocks_per_stage=(1, 1, 1, 1),
    embed_dim_per_stage=(8, 16, 32, 64),
    heads_per_stage=(1, 2, 4, 8),
    window_size_per_stage=(4, 2, 2, 2),
    global_attention_blocks=(2,),
    window_pos_bg_size=(2, 2),
)


def window_partition(x: torch.Tensor, ws: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """[B, H, W, C] -> [B*nw, ws, ws, C] with zero padding."""
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw: tuple[int, int], hw: tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp // ws) * (wp // ws))
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def _max_pool2(x: torch.Tensor, stride: int) -> torch.Tensor:
    """[B, H, W, C] max pool, kernel = stride (floor mode)."""
    b, h, w, c = x.shape
    h2, w2 = h // stride, w // stride
    x = x[:, : h2 * stride, : w2 * stride].reshape(b, h2, stride, w2, stride, c)
    return x.amax(dim=(2, 4))


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, query_stride: int | None,
                 dtype: torch.dtype, use_flash: bool = False):
        super().__init__()
        self.dim_out, self.num_heads, self.query_stride, self.use_flash = dim_out, num_heads, query_stride, use_flash
        self.qkv = Dense(dim, 3 * dim_out, dtype=dtype)
        self.proj = Dense(dim_out, dim_out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        head_dim = self.dim_out // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, head_dim)
        q, k, v = qkv.unbind(2)  # [B, N, heads, hd]
        if self.query_stride:
            q = _max_pool2(q.reshape(b, h, w, self.num_heads * head_dim), self.query_stride)
            h, w = q.shape[1], q.shape[2]
            q = q.reshape(b, h * w, self.num_heads, head_dim)
        scale = head_dim**-0.5
        if self.use_flash:
            from benchmark.reference.frozen.attention import flash_attention_auto

            qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
            out = flash_attention_auto(qh, kh, vh, scale).permute(0, 2, 1, 3).reshape(b, h, w, self.dim_out)
        else:
            logits = attention.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
            weights = torch.softmax(logits, dim=-1).to(v.dtype)
            out = attention.einsum("bhnm,bmhd->bnhd", weights, v).reshape(b, h, w, self.dim_out)
        return self.proj(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, window_size: int, query_stride: int | None,
                 mlp_ratio: float, dtype: torch.dtype, use_flash: bool = False):
        super().__init__()
        self.window_size, self.query_stride = window_size, query_stride
        self.norm1 = LayerNorm(dim, dtype=dtype)
        if dim != dim_out:
            self.proj = Dense(dim, dim_out, dtype=dtype)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, query_stride, dtype,
                                        use_flash=use_flash and window_size == 0 and not query_stride)
        self.norm2 = LayerNorm(dim_out, dtype=dtype)
        self.mlp = FeedForward(dim_out, int(dim_out * mlp_ratio), dim_out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        h = self.norm1(x)
        if hasattr(self, "proj"):
            proj = self.proj(h)
            residual = _max_pool2(proj, self.query_stride) if self.query_stride else proj
        ws = self.window_size
        hw = pad_hw = (h.shape[1], h.shape[2])
        if ws > 0:
            h, pad_hw = window_partition(h, ws)
        h = self.attn(h)
        if self.query_stride:
            ws = ws // self.query_stride
            hw = (residual.shape[1], residual.shape[2])
            pad_h = (ws - hw[0] % ws) % ws if ws > 0 else 0
            pad_w = (ws - hw[1] % ws) % ws if ws > 0 else 0
            pad_hw = (hw[0] + pad_h, hw[1] + pad_w)
        if self.window_size > 0:
            h = window_unpartition(h, ws, pad_hw, hw)
        x = residual + h
        return x + self.mlp(self.norm2(x))


class Hiera(nn.Module):
    """pixels [B, 3, H, W] -> the per-stage feature maps [B, H_s, W_s, C_s]."""

    def __init__(self, config: HieraConfig):
        super().__init__()
        cfg = self.config = config
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_kernel, stride=cfg.patch_stride,
                                     padding=cfg.patch_padding, dtype=cfg.dtype)
        ws0 = cfg.window_size_per_stage[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, *cfg.window_pos_bg_size, cfg.embed_dim))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, ws0, ws0, cfg.embed_dim))
        total = 0
        for stage, n_blocks in enumerate(cfg.blocks_per_stage):
            for i in range(n_blocks):
                first = stage > 0 and i == 0
                dim = cfg.embed_dim_per_stage[stage - 1] if first else cfg.embed_dim_per_stage[stage]
                ws = cfg.window_size_per_stage[stage - 1] if first else cfg.window_size_per_stage[stage]
                if total in cfg.global_attention_blocks:
                    ws = 0
                q_stride = cfg.query_stride if first and stage <= cfg.num_query_pool_stages else None
                self.add_module(f"block{total}", MultiScaleBlock(
                    dim, cfg.embed_dim_per_stage[stage], cfg.heads_per_stage[stage], ws, q_stride,
                    cfg.mlp_ratio, cfg.dtype, use_flash=cfg.use_flash))
                total += 1

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        from benchmark.reference.frozen.sampling import resize_bicubic_torch

        cfg = self.config
        x = self.patch_embed(pixels.to(cfg.dtype)).permute(0, 2, 3, 1)
        h, w = x.shape[1], x.shape[2]
        # Windowed position embedding: the background embedding bicubically
        # resized to (h, w) plus the tiled window embedding.
        ws0 = cfg.window_size_per_stage[0]
        pos = resize_bicubic_torch(self.pos_embed.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
        pos = pos + self.pos_embed_window.tile(1, h // ws0, w // ws0, 1)
        x = x + pos.to(cfg.dtype)
        outputs, total = [], 0
        for n_blocks in cfg.blocks_per_stage:
            for _ in range(n_blocks):
                x = getattr(self, f"block{total}")(x)
                total += 1
            outputs.append(x)
        return outputs


def sine_position_encoding(shape: tuple[int, int], dim: int, temperature: float = 10000.0,
                           device=None) -> torch.Tensor:
    """[H, W, dim] normalised sine/cosine position features (SAM2's
    PositionEmbeddingSine, normalize=True), fp32."""
    h, w = shape
    npf = dim // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    eps = 1e-6
    y = y / (h + eps) * 2 * math.pi
    x = x / (w + eps) * 2 * math.pi
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / npf)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


class FpnNeck(nn.Module):
    """Top-down FPN over the Hiera stage outputs -> (high-res first) the
    [B, H, W, fpn_dim] features of the num_feature_levels finest levels, and
    their [H, W, fpn_dim] sine positions."""

    def __init__(self, in_dims: tuple, fpn_dim: int = 256, top_down_levels: tuple = (2, 3),
                 num_feature_levels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fpn_dim, self.top_down_levels, self.num_feature_levels = fpn_dim, top_down_levels, num_feature_levels
        n = len(in_dims) - 1
        for i in range(n, -1, -1):  # conv{j} reads stage n - j, as in the JAX tree
            self.add_module(f"conv{n - i}", Conv(in_dims[i], fpn_dim, 1, dtype=dtype))

    def forward(self, stage_feats: list[torch.Tensor]):
        n = len(stage_feats) - 1
        feats: list = [None] * (n + 1)
        prev = None
        for i in range(n, -1, -1):
            lateral = getattr(self, f"conv{n - i}")(stage_feats[i])
            if i in self.top_down_levels and i != n and prev is not None:
                up = prev.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                prev = lateral + up.to(lateral.dtype)
            else:
                prev = lateral
            feats[i] = prev
        chosen = feats[: self.num_feature_levels]
        pos = [sine_position_encoding(f.shape[1:3], self.fpn_dim, device=f.device) for f in chosen]
        return chosen, pos
