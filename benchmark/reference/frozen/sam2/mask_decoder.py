"""SAM2 mask decoder: two-way transformer, upscaling and output heads.

Counterpart of freepose_tpu.models.sam2.mask_decoder: object-score, IoU and
mask tokens cross-attend with the image embedding both ways, masks decode
through a 4x transposed-conv upscaler fused with the two high-resolution
FPN levels, with the stability-based single/multi-mask fallback. Decoder
attention is a plain einsum (a handful of tokens), as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.frozen import attention
from benchmark.reference.frozen.layers import ConvTranspose, Dense, LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    hidden_size: int = 256
    num_layers: int = 2
    num_heads: int = 8
    mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden: int = 256
    downsample_rate: int = 2
    stability_delta: float = 0.05
    stability_thresh: float = 0.98
    dtype: torch.dtype = torch.float32

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


class DecoderAttention(nn.Module):
    """Attention with optional internal downsampling (SAM style), on
    [B, P, tokens, D] inputs."""

    def __init__(self, hidden: int, heads: int, downsample: int, dtype: torch.dtype):
        super().__init__()
        inner = hidden // downsample
        self.heads, self.inner = heads, inner
        self.q = Dense(hidden, inner, dtype=dtype)
        self.k = Dense(hidden, inner, dtype=dtype)
        self.v = Dense(hidden, inner, dtype=dtype)
        self.out = Dense(inner, hidden, dtype=dtype)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        head_dim = self.inner // self.heads
        b, p = q.shape[:2]

        def proj(x, layer):
            return layer(x).reshape(b * p, -1, self.heads, head_dim).transpose(1, 2)

        qh, kh, vh = proj(q, self.q), proj(k, self.k), proj(v, self.v)
        logits = attention.mm(qh.float(), kh.float().transpose(-1, -2)) * head_dim**-0.5
        w = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = attention.mm(w, vh).transpose(1, 2).reshape(b, p, -1, self.inner)
        return self.out(out)


class FeedForwardN(nn.Module):
    """proj_in -> act -> hidden layers -> proj_out (SAM's FeedForward)."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int, sigmoid_output: bool = False,
                 act: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.sigmoid_output = num_layers, sigmoid_output
        self.act = F.relu if act == "relu" else gelu
        self.proj_in = Dense(dim, hidden, dtype=dtype)
        for i in range(num_layers - 2):
            self.add_module(f"layer{i}", Dense(hidden, hidden, dtype=dtype))
        self.proj_out = Dense(hidden, out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.proj_in(x))
        for i in range(self.num_layers - 2):
            x = self.act(getattr(self, f"layer{i}")(x))
        x = self.proj_out(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig, skip_first_pe: bool):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.skip_first_pe = skip_first_pe
        self.self_attn = DecoderAttention(c.hidden_size, c.num_heads, 1, dt)
        self.ln1 = LayerNorm(c.hidden_size, dtype=dt)
        self.cross_t2i = DecoderAttention(c.hidden_size, c.num_heads, c.downsample_rate, dt)
        self.ln2 = LayerNorm(c.hidden_size, dtype=dt)
        self.mlp = FeedForwardN(c.hidden_size, c.mlp_dim, c.hidden_size, num_layers=c.num_layers, dtype=dt)
        self.ln3 = LayerNorm(c.hidden_size, dtype=dt)
        self.cross_i2t = DecoderAttention(c.hidden_size, c.num_heads, c.downsample_rate, dt)
        self.ln4 = LayerNorm(c.hidden_size, dtype=dt)

    def forward(self, queries, keys, q_pe, k_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + q_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.ln1(queries)
        q, k = queries + q_pe, keys + k_pe
        queries = self.ln2(queries + self.cross_t2i(q, k, keys))
        queries = self.ln3(queries + self.mlp(queries))
        q, k = queries + q_pe, keys + k_pe
        keys = self.ln4(keys + self.cross_i2t(k, q, queries))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = cfg
        self.obj_score_token = nn.Parameter(torch.zeros(1, c.hidden_size))
        self.iou_token = nn.Parameter(torch.zeros(1, c.hidden_size))
        self.mask_tokens = nn.Parameter(torch.zeros(c.num_mask_tokens, c.hidden_size))
        for i in range(c.num_layers):
            self.add_module(f"block{i}", TwoWayBlock(c, skip_first_pe=(i == 0)))
        self.final_t2i = DecoderAttention(c.hidden_size, c.num_heads, c.downsample_rate, dt)
        self.ln_final = LayerNorm(c.hidden_size, dtype=dt)
        self.upscale1 = ConvTranspose(c.hidden_size, c.hidden_size // 4, 2, dtype=dt)
        self.upscale_ln = LayerNorm(c.hidden_size // 4, dtype=dt)
        self.upscale2 = ConvTranspose(c.hidden_size // 4, c.hidden_size // 8, 2, dtype=dt)
        for i in range(c.num_mask_tokens):
            self.add_module(f"hyper{i}", FeedForwardN(c.hidden_size, c.hidden_size, c.hidden_size // 8, 3, dtype=dt))
        self.iou_head = FeedForwardN(c.hidden_size, c.iou_head_hidden, c.num_mask_tokens, c.iou_head_depth,
                                     sigmoid_output=True, dtype=dt)
        self.obj_head = FeedForwardN(c.hidden_size, c.hidden_size, 1, 3, dtype=dt)

    def forward(self, image_embedding, image_pe, sparse_prompts, dense_prompts, high_res_feats,
                multimask_output: bool, every_mask: bool = False):
        """image_embedding [B, G, G, D], image_pe [G, G, D], sparse_prompts
        [B, P, S, D], dense_prompts [B, G, G, D] (or [B, P, G, G, D]),
        high_res_feats (s0 [B, 4G, 4G, D/8], s1 [B, 2G, 2G, D/4]) ->
        (masks [B, P, M, 4G, 4G], iou [B, P, M], sam tokens [B, P, M, D],
        object-score logits [B, P, 1])."""
        c = self.cfg
        dt = c.dtype
        b, g = image_embedding.shape[0], image_embedding.shape[1]
        p = sparse_prompts.shape[1]
        out_tokens = torch.cat([self.obj_score_token, self.iou_token, self.mask_tokens], dim=0).to(dt)
        tokens = out_tokens[None, None].expand(b, p, -1, -1)
        tokens = torch.cat([tokens, sparse_prompts.to(dt)], dim=2)
        if dense_prompts.ndim == 5:  # per-prompt dense embeddings (mask inputs)
            keys = image_embedding.reshape(b, 1, g * g, -1) + dense_prompts.reshape(b, p, g * g, -1)
        else:
            src = image_embedding + dense_prompts
            keys = src.reshape(b, 1, g * g, -1).expand(b, p, g * g, src.shape[-1])
        k_pe = image_pe.reshape(1, 1, g * g, -1).to(dt).expand(b, p, g * g, image_pe.shape[-1])

        queries = tokens
        for i in range(c.num_layers):
            queries, keys = getattr(self, f"block{i}")(queries, keys, tokens, k_pe)
        q, k = queries + tokens, keys + k_pe
        queries = self.ln_final(queries + self.final_t2i(q, k, keys))

        iou_out = queries[:, :, 1]
        mask_tokens_out = queries[:, :, 2 : 2 + c.num_mask_tokens]

        # Upscale the prompt-conditioned image embedding 4x, fusing the two
        # high-resolution pyramid levels.
        src_img = keys.reshape(b * p, g, g, c.hidden_size)
        feat_s0, feat_s1 = high_res_feats
        feat_s0 = feat_s0.repeat_interleave(p, dim=0)
        feat_s1 = feat_s1.repeat_interleave(p, dim=0)
        up = self.upscale1(src_img) + feat_s1
        up = gelu(self.upscale_ln(up))
        up = gelu(self.upscale2(up) + feat_s0)  # [B*P, 4G, 4G, D/8]

        hyper = torch.stack([getattr(self, f"hyper{i}")(mask_tokens_out[:, :, i])
                             for i in range(c.num_mask_tokens)], dim=2)  # [B, P, T, D/8]
        up_flat = up.reshape(b, p, (4 * g) * (4 * g), c.hidden_size // 8)
        masks = torch.matmul(hyper, up_flat.transpose(-1, -2)).reshape(b, p, c.num_mask_tokens, 4 * g, 4 * g)

        iou_pred = self.iou_head(iou_out)
        obj_logits = self.obj_head(queries[:, :, 0])
        if every_mask:  # every mask token's output, the single mask first
            return masks, iou_pred, mask_tokens_out, obj_logits
        if multimask_output:
            return masks[:, :, 1:], iou_pred[:, :, 1:], mask_tokens_out[:, :, 1:], obj_logits
        masks_out, iou_pred_out = self._dynamic_fallback(masks, iou_pred)
        return masks_out, iou_pred_out, mask_tokens_out[:, :, 0:1], obj_logits

    def _stability(self, logits: torch.Tensor) -> torch.Tensor:
        d = self.cfg.stability_delta
        flat = logits.reshape(*logits.shape[:-2], -1)
        ai = (flat > d).sum(dim=-1).float()
        au = (flat > -d).sum(dim=-1).float()
        return torch.where(au > 0, ai / torch.clamp(au, min=1.0), torch.ones_like(au))

    def _dynamic_fallback(self, masks: torch.Tensor, iou_pred: torch.Tensor):
        """Single-mask output, falling back to the best multimask candidate
        when the single mask is unstable."""
        multi, multi_iou = masks[:, :, 1:], iou_pred[:, :, 1:]
        best = multi_iou.argmax(dim=-1)  # [B, P]
        best_mask = torch.gather(multi, 2, best[..., None, None, None].expand(-1, -1, 1, *multi.shape[3:]))
        best_iou = torch.gather(multi_iou, 2, best[..., None])
        single, single_iou = masks[:, :, 0:1], iou_pred[:, :, 0:1]
        stable = self._stability(single) >= self.cfg.stability_thresh  # [B, P, 1]
        return (torch.where(stable[..., None, None], single, best_mask),
                torch.where(stable, single_iou, best_iou))
