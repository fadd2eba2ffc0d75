"""Swin Transformer backbone (GroundingDINO's vision tower), as nn.Modules.

Counterpart of freepose_tpu.models.swin (HF SwinBackbone semantics):
windowed attention with a relative position bias, shifted windows on odd
blocks, 2x2 patch merging, per-stage output norms; maps are NHWC. A stage
grid that is not a multiple of the window is padded up to one (at 800²,
Swin-B's stage grids 200, 100, 50 and 25 become 204, 108, 60 and 36 for its
window 12), the shift mask is built on the padded grid, and the output is
cropped back; patch merging first pads an odd side by one. Attention
logits are fp32 whatever the compute dtype. Module and parameter names
follow the JAX tree (models/convert.py:swin_from_jax).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freepose_tpu_torch.models.layers import Conv, Dense, LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96  # swin-tiny
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_stages: tuple = (1, 2, 3)  # 0-based stage indices to emit
    always_partition: bool = True  # HF SwinBackbone semantics
    dtype: torch.dtype = torch.float32

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2**i)


SWIN_TEST = SwinConfig(embed_dim=16, depths=(1, 1, 2), num_heads=(1, 2, 4), window_size=4, out_stages=(1, 2))

# The grounding-dino-base backbone (Swin-B pretrained at 384, window 12).
SWIN_B = SwinConfig(
    embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
    window_size=12, out_stages=(1, 2, 3),
)


def _rel_pos_index(window: int, table_window: int | None = None) -> np.ndarray:
    """[w², w²] indices into the relative-position bias table of a
    `table_window` (default: `window`) block, for a window of `window`."""
    full = window if table_window is None else table_window
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += full - 1
    rel[:, :, 1] += full - 1
    rel[:, :, 0] *= 2 * full - 1
    return rel.sum(-1)


def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """[nW, w², w²] additive mask for shifted windows (HF get_attn_mask)."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _window_tables(window: int, table_window: int, hp: int, wp: int, shift: int, device: torch.device):
    """The bias-table indices and, for a shifted window, the shift mask, as
    tensors on `device`; built once per grid."""
    idx = torch.as_tensor(_rel_pos_index(window, table_window).reshape(-1), device=device)
    mask = torch.as_tensor(_shift_attn_mask(hp, wp, window, shift), device=device) if shift > 0 else None
    return idx, mask


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float,
                 dtype: torch.dtype, always_partition: bool = True):
        super().__init__()
        self.dim, self.num_heads, self.window, self.shift = dim, num_heads, window, shift
        self.always_partition = always_partition
        self.ln1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = Dense(dim, dim, dtype)
        self.ln2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, c = x.shape
        if self.always_partition:
            window, shift = self.window, self.shift
        else:
            window = min(self.window, h, w)
            shift = 0 if min(h, w) <= self.window else self.shift
        nh, n = self.num_heads, window * window

        res = x
        x = self.ln1(x)
        pad_h = (window - h % window) % window
        pad_w = (window - w % window) % window
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = x.reshape(b, hp // window, window, wp // window, window, c)
        xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, n, c)

        head_dim = c // nh
        qkv = self.qkv(xw).reshape(xw.shape[0], n, 3, nh, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (head_dim**-0.5)
        # The (possibly clipped) window's offsets into the full-size table.
        idx, mask = _window_tables(window, self.window, hp, wp, shift, x.device)
        bias = self.rel_bias_table[idx].reshape(n, n, nh)
        logits = logits + bias.permute(2, 0, 1)[None].float()
        if shift > 0:
            n_windows = mask.shape[0]
            logits = logits.reshape(b, n_windows, nh, n, n) + mask[None, :, None]
            logits = logits.reshape(-1, nh, n, n)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(xw.shape[0], n, c)
        out = self.proj(out)

        out = out.reshape(b, hp // window, wp // window, window, window, c)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = res + out[:, :h, :w]
        return x + self.fc2(gelu(self.fc1(self.ln2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5, dtype=dtype)
        self.reduction = Dense(4 * dim, 2 * dim, dtype, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C] -> [B, H/2, W/2, 2C]
        _, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        merged = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(merged))


class SwinBackbone(nn.Module):
    def __init__(self, config: SwinConfig):
        super().__init__()
        cfg = self.config = config
        self.patch_embed = Conv(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size, dtype=cfg.dtype)
        self.embed_norm = LayerNorm(cfg.embed_dim, eps=1e-5, dtype=cfg.dtype)
        for stage, depth in enumerate(cfg.depths):
            dim = cfg.stage_dim(stage)
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, cfg.num_heads[stage], cfg.window_size, shift=0 if blk % 2 == 0 else cfg.window_size // 2,
                    mlp_ratio=cfg.mlp_ratio, dtype=cfg.dtype, always_partition=cfg.always_partition))
            if stage in cfg.out_stages:
                self.add_module(f"out_norm{stage}", LayerNorm(dim, eps=1e-5, dtype=cfg.dtype))
            if stage + 1 < len(cfg.depths):
                self.add_module(f"downsample{stage}", PatchMerging(dim, cfg.dtype))

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        """[B, 3, H, W] (H and W multiples of the patch size) -> list of
        [B, H_s, W_s, C_s] for out_stages."""
        cfg = self.config
        x = self.embed_norm(self.patch_embed(pixels.permute(0, 2, 3, 1)))
        outputs = []
        for stage, depth in enumerate(cfg.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
            if stage in cfg.out_stages:
                outputs.append(getattr(self, f"out_norm{stage}")(x))
            if stage + 1 < len(cfg.depths):
                x = getattr(self, f"downsample{stage}")(x)
        return outputs
