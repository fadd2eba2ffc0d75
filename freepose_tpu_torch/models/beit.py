"""BEiT vision backbone (the ZoeD_N trunk) as nn.Modules.

Counterpart of freepose_tpu.models.beit: a BEiT-L/16 with a relative
position bias per block and layer scale, tapped at four depths. Kept from
the JAX model, for parity with the HF checkpoints it converts:

  * the key projection has no bias; LayerNorm eps is 1e-12; GELU is exact;
  * the relative position index gives the cls rows the last three table
    rows;
  * the table is sized by the pretrain window; another window resizes its
    spatial part bilinearly with HF's width/height-swapped reshape.

With `use_flash` every block's attention goes to `flash_attention_bias_auto`:
kernel K5 on the card ([1, 16, 577, 64] fp32 at ZoeD_N's 384² input), its
plain version on the CPU. Module and parameter names follow the JAX tree,
whose scanned blocks/block stack models/convert.py:zoedepth_from_jax
unstacks into `blocks.<i>`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freepose_tpu_torch.models.layers import Dense, LayerNorm
from freepose_tpu_torch.ops.sampling import resize_bilinear


@dataclasses.dataclass(frozen=True)
class BeitConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 384
    layer_norm_eps: float = 1e-12
    layer_scale_init: float = 0.1
    out_indices: tuple = (6, 12, 18, 24)  # 1-indexed block taps
    dtype: torch.dtype = torch.float32
    use_flash: bool = False  # attention through flash_attention_bias_auto (K5 on the card)


BEIT_TEST = BeitConfig(
    hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
    patch_size=16, image_size=64, out_indices=(1, 2, 3, 4),
)


def relative_position_index(window: tuple[int, int]) -> np.ndarray:
    """[N+1, N+1] gather indices into the (2h-1)(2w-1)+3 bias table; the last
    three rows serve cls→token / token→cls / cls→cls."""
    h, w = window
    num_rel = (2 * h - 1) * (2 * w - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    n = h * w
    idx = np.zeros((n + 1, n + 1), np.int32)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


class BeitBlock(nn.Module):
    """Pre-LN attention with relative position bias and layer scale, then a
    pre-LN exact-GELU MLP with layer scale."""

    def __init__(self, config: BeitConfig):
        super().__init__()
        c = self.config = config
        d, nh = c.hidden_size, c.num_heads
        pre = c.image_size // c.patch_size
        self.pretrain_window = (pre, pre)
        self.rel_pos_table = nn.Parameter(torch.zeros(((2 * pre - 1) ** 2 + 3, nh)))
        self.ln1 = LayerNorm(d, eps=c.layer_norm_eps)
        self.q = Dense(d, d, dtype=c.dtype)
        self.k = Dense(d, d, dtype=c.dtype, bias=False)
        self.v = Dense(d, d, dtype=c.dtype)
        self.proj = Dense(d, d, dtype=c.dtype)
        self.lambda_1 = nn.Parameter(torch.full((d,), c.layer_scale_init))
        self.ln2 = LayerNorm(d, eps=c.layer_norm_eps)
        self.fc1 = Dense(d, c.intermediate_size, dtype=c.dtype)
        self.fc2 = Dense(c.intermediate_size, d, dtype=c.dtype)
        self.lambda_2 = nn.Parameter(torch.full((d,), c.layer_scale_init))

    def relative_bias(self, window: tuple[int, int], index: torch.Tensor | None = None) -> torch.Tensor:
        """[heads, N+1, N+1] fp32 logit bias for `window` (index: the
        window's `relative_position_index` on the table's device)."""
        nh = self.config.num_heads
        table = self.rel_pos_table.float()
        if tuple(window) != self.pretrain_window:
            # The MiDaS-3.1 arbitrary-window scheme (HF modeling_beit.py:598-631),
            # including its width/height-swapped reshape, kept for weight parity.
            oh, ow = 2 * self.pretrain_window[0] - 1, 2 * self.pretrain_window[1] - 1
            nh2, nw2 = 2 * window[0] - 1, 2 * window[1] - 1
            n_sub = table.shape[0] - 3
            sub = table[:n_sub].reshape(ow, oh, nh).permute(2, 0, 1)
            sub = resize_bilinear(sub, (nh2, nw2)).permute(1, 2, 0).reshape(nh2 * nw2, nh)
            table = torch.cat([sub, table[n_sub:]], dim=0)
        if index is None:
            index = torch.as_tensor(relative_position_index(window), device=table.device)
        n_tok = index.shape[0]
        return table[index.reshape(-1).long()].reshape(n_tok, n_tok, nh).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, window: tuple[int, int], index: torch.Tensor | None = None) -> torch.Tensor:
        c = self.config
        b, n, d = x.shape
        nh = c.num_heads
        hd = d // nh
        bias = self.relative_bias(window, index)
        h = self.ln1(x)
        q, k, v = (t.reshape(b, n, nh, hd).transpose(1, 2) for t in (self.q(h), self.k(h), self.v(h)))
        if c.use_flash:
            # K5 streams K/V and the [heads, N, N] bias in tiles; the fp32
            # logit tensor of the dense path never materialises.
            from freepose_tpu_torch.ops.attention import flash_attention_bias_auto

            out = flash_attention_bias_auto(q.contiguous(), k.contiguous(), v.contiguous(), 1.0 / math.sqrt(hd),
                                            bias)
        else:
            logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd) + bias
            attn = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = self.proj(out.transpose(1, 2).reshape(b, n, d))
        x = x + self.lambda_1 * out
        h = self.fc2(F.gelu(self.fc1(self.ln2(x))))
        return x + self.lambda_2 * h


class BeitBackbone(nn.Module):
    """BEiT trunk: pixels [B, 3, H, W] -> (token-form taps [B, N+1, D] at
    out_indices, window), as HF BeitBackbone with
    reshape_hidden_states=False."""

    def __init__(self, config: BeitConfig):
        super().__init__()
        c = self.config = config
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size, dtype=c.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.blocks = nn.ModuleList(BeitBlock(c) for _ in range(c.num_layers))
        self._index: dict[tuple, torch.Tensor] = {}  # relative position index by (window, device)

    def forward(self, pixels: torch.Tensor):
        c = self.config
        b = pixels.shape[0]
        window = (pixels.shape[2] // c.patch_size, pixels.shape[3] // c.patch_size)
        tokens = self.patch_embed(pixels.to(c.dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(tokens.dtype).expand(b, 1, c.hidden_size), tokens], dim=1)
        key = (window, pixels.device)
        if key not in self._index:
            self._index[key] = torch.as_tensor(relative_position_index(window), device=pixels.device)
        taps = []
        for i, block in enumerate(self.blocks, start=1):
            x = block(x, window, self._index[key])
            if i in c.out_indices:
                taps.append(x)
        return tuple(taps), window
