"""SAM2 video memory: RoPE memory attention + memory encoder, as nn.Modules.

Counterpart of freepose_tpu.models.sam2.memory. The memory bank has a fixed
capacity (7 spatial mask memories + 16 object pointers, padded and masked),
as in the JAX package. RoPE runs in fp32 and is cast back to the working
dtype; object-pointer tokens are excluded from it. On the card memory
self-attention goes to kernel K2 and the masked cross-attention over
~28.7k keys to kernel K4, both through `flash_attention_auto`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.frozen import attention
from benchmark.reference.frozen.layers import Conv, Dense, LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 1
    downsample_rate: int = 1
    ff_hidden: int = 2048
    rope_theta: float = 10000.0
    rope_feat_size: int = 64  # memory / current feature grid side
    mem_dim: int = 64  # memory channel dim (kv input to cross attention)
    num_maskmem: int = 7
    max_obj_ptrs: int = 16
    memory_temporal_stride: int = 1
    # memory encoder
    enc_hidden: int = 256
    fuser_layers: int = 2
    fuser_intermediate: int = 1024
    fuser_kernel: int = 7
    mask_down_kernel: int = 3
    mask_down_stride: int = 2
    mask_down_total_stride: int = 16
    sigmoid_scale: float = 20.0
    sigmoid_bias: float = -10.0
    dtype: torch.dtype = torch.float32
    use_flash: bool = False  # attention through flash_attention_auto (K2 / K4 on the card)


def rope_2d_cos_sin(head_dim: int, grid: int, theta: float = 10000.0):
    """Axial 2D RoPE tables [grid*grid, head_dim] (cos, sin), fp32."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 4)[: head_dim // 4] / head_dim))
    idx = np.arange(grid * grid)
    f = np.concatenate([np.outer(idx % grid, freqs), np.outer(idx // grid, freqs)], axis=-1)
    f = np.repeat(f, 2, axis=-1)  # interleaved pairs
    return torch.as_tensor(np.cos(f), dtype=torch.float32), torch.as_tensor(np.sin(f), dtype=torch.float32)


def _rotate_pairwise(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(*x.shape[:-2], -1)


def apply_rope_2d(q, k, cos, sin, num_k_exclude: int = 0, repeat_freqs_k: bool = False):
    """Rotate q fully and the first len(k) - num_k_exclude keys, in fp32;
    the results come back in the inputs' dtypes."""
    qf = q.float()
    q_rot = qf * cos + _rotate_pairwise(qf) * sin
    n_rot = k.shape[-2] - num_k_exclude
    k_part = k[..., :n_rot, :].float()
    if repeat_freqs_k and n_rot != q.shape[-2]:
        rep = n_rot // q.shape[-2]
        cos_k, sin_k = cos.repeat(rep, 1), sin.repeat(rep, 1)
    else:
        cos_k, sin_k = cos, sin
    k_rot = k_part * cos_k + _rotate_pairwise(k_part) * sin_k
    return q_rot.to(q.dtype), torch.cat([k_rot.to(k.dtype), k[..., n_rot:, :]], dim=-2)


class RopeAttention(nn.Module):
    def __init__(self, cfg: MemoryConfig, kv_in_dim: int | None = None, rope_k_repeat: bool = False):
        super().__init__()
        self.cfg, self.rope_k_repeat = cfg, rope_k_repeat
        inner = cfg.hidden_size // cfg.downsample_rate
        kv_in = kv_in_dim or cfg.hidden_size
        self.q = Dense(cfg.hidden_size, inner, dtype=cfg.dtype)
        self.k = Dense(kv_in, inner, dtype=cfg.dtype)
        self.v = Dense(kv_in, inner, dtype=cfg.dtype)
        self.out = Dense(inner, cfg.hidden_size, dtype=cfg.dtype)

    def forward(self, q, k, v, cos, sin, num_k_exclude: int = 0, kv_mask=None):
        c = self.cfg
        inner = c.hidden_size // c.downsample_rate
        head_dim = inner // c.num_heads
        b = q.shape[0]

        def proj(x, layer):
            return layer(x).reshape(b, -1, c.num_heads, head_dim).transpose(1, 2)

        qh, kh, vh = proj(q, self.q), proj(k, self.k), proj(v, self.v)
        qh, kh = apply_rope_2d(qh, kh, cos, sin, num_k_exclude, self.rope_k_repeat)
        scale = head_dim**-0.5
        if c.use_flash:
            from benchmark.reference.frozen.attention import flash_attention_auto

            out = flash_attention_auto(qh.contiguous(), kh.contiguous(), vh.contiguous(), scale, kv_mask=kv_mask)
        else:
            logits = attention.mm(qh.float(), kh.float().transpose(-1, -2)) * scale
            if kv_mask is not None:
                logits = logits.masked_fill(~kv_mask[:, None, None, :], -math.inf)
            out = attention.mm(torch.softmax(logits, dim=-1).to(vh.dtype), vh)
        return self.out(out.transpose(1, 2).reshape(b, -1, inner))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: MemoryConfig):
        super().__init__()
        dt = cfg.dtype
        self.ln1 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.self_attn = RopeAttention(cfg)
        self.ln2 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.cross_attn = RopeAttention(cfg, kv_in_dim=cfg.mem_dim, rope_k_repeat=True)
        self.ln3 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.fc1 = Dense(cfg.hidden_size, cfg.ff_hidden, dtype=dt)
        self.fc2 = Dense(cfg.ff_hidden, cfg.hidden_size, dtype=dt)

    def forward(self, queries, memory, memory_pos, cos, sin, num_ptr_tokens: int, kv_mask):
        q = self.ln1(queries)
        queries = queries + self.self_attn(q, q, q, cos, sin)
        q = self.ln2(queries)
        queries = queries + self.cross_attn(q, memory + memory_pos, memory, cos, sin,
                                            num_k_exclude=num_ptr_tokens, kv_mask=kv_mask)
        q = self.ln3(queries)
        return queries + self.fc2(F.relu(self.fc1(q)))


class MemoryAttention(nn.Module):
    """Condition current-frame features on the (padded) memory bank."""

    def __init__(self, cfg: MemoryConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", MemoryAttentionLayer(cfg))
        self.ln_final = LayerNorm(cfg.hidden_size, dtype=cfg.dtype)
        # The RoPE tables are constants: built once and moved with the
        # module, not uploaded on every call (4 MB each at hidden 256).
        cos, sin = rope_2d_cos_sin(cfg.hidden_size // (cfg.downsample_rate * cfg.num_heads), cfg.rope_feat_size,
                                   cfg.rope_theta)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, curr_feats, curr_pos, memory, memory_pos, num_ptr_tokens: int, kv_mask):
        """curr_feats / curr_pos [B, HW, hidden]; memory / memory_pos
        [B, M, mem_dim] (spatial memories, then pointer tokens); kv_mask
        [B, M] bool validity."""
        c = self.cfg
        out = curr_feats + 0.1 * curr_pos
        for i in range(c.num_layers):
            out = getattr(self, f"layer{i}")(out, memory, memory_pos, self.rope_cos, self.rope_sin, num_ptr_tokens,
                                             kv_mask)
        return self.ln_final(out)


class CXBlock(nn.Module):
    """ConvNeXt block of the memory fuser."""

    def __init__(self, cfg: MemoryConfig, dim: int):
        super().__init__()
        dt = cfg.dtype
        self.dwconv = Conv(dim, dim, cfg.fuser_kernel, padding=cfg.fuser_kernel // 2, groups=dim, dtype=dt)
        self.ln = LayerNorm(dim, dtype=dt)
        self.pw1 = Dense(dim, cfg.fuser_intermediate, dtype=dt)
        self.pw2 = Dense(cfg.fuser_intermediate, dim, dtype=dt)
        self.scale = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        h = self.pw2(gelu(self.pw1(self.ln(self.dwconv(x)))))
        return x + h * self.scale.to(h.dtype)


class MaskDownSampler(nn.Module):
    def __init__(self, cfg: MemoryConfig):
        super().__init__()
        dt = cfg.dtype
        self.n_layers = int(np.log2(cfg.mask_down_total_stride) / np.log2(cfg.mask_down_stride))
        ch = 1
        for i in range(self.n_layers):
            out = ch * cfg.mask_down_stride**2
            self.add_module(f"conv{i}", Conv(ch, out, cfg.mask_down_kernel, stride=cfg.mask_down_stride,
                                             padding=cfg.mask_down_kernel // 2, dtype=dt))
            self.add_module(f"ln{i}", LayerNorm(out, dtype=dt))
            ch = out
        self.final_conv = Conv(ch, cfg.enc_hidden, 1, dtype=dt)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:  # [B, H, W, 1] -> [B, H/16, W/16, enc_hidden]
        x = masks
        for i in range(self.n_layers):
            x = gelu(getattr(self, f"ln{i}")(getattr(self, f"conv{i}")(x)))
        return self.final_conv(x)


class MemoryEncoder(nn.Module):
    """Fuse pixel features with the predicted mask into a mem_dim memory map."""

    def __init__(self, cfg: MemoryConfig, in_dim: int | None = None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.mask_down = MaskDownSampler(cfg)
        self.feature_proj = Conv(in_dim or cfg.enc_hidden, cfg.enc_hidden, 1, dtype=dt)
        for i in range(cfg.fuser_layers):
            self.add_module(f"fuser{i}", CXBlock(cfg, cfg.enc_hidden))
        self.out_proj = Conv(cfg.enc_hidden, cfg.mem_dim, 1, dtype=dt)

    def forward(self, pix_feats: torch.Tensor, masks: torch.Tensor):
        """pix_feats [B, H, W, C]; masks [B, Him, Wim, 1], already
        sigmoid-scaled -> (memory [B, H, W, mem_dim], pos [H, W, mem_dim])."""
        from benchmark.reference.frozen.sam2.hiera import sine_position_encoding

        x = self.feature_proj(pix_feats) + self.mask_down(masks)
        for i in range(self.cfg.fuser_layers):
            x = getattr(self, f"fuser{i}")(x)
        x = self.out_proj(x)
        return x, sine_position_encoding((x.shape[1], x.shape[2]), self.cfg.mem_dim, device=x.device)


def sine_1d_pe(positions: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """[N] positions -> [N, dim] 1D sine PE."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=positions.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / pe_dim)
    pos = positions[..., None] / dim_t
    return torch.cat([pos.sin(), pos.cos()], dim=-1)
