"""GroundingDINO open-vocabulary detector, as nn.Modules.

Counterpart of freepose_tpu.models.grounding_dino: a Swin backbone and a
BERT text tower, 6 encoder layers of (vision-text bi-attention fusion, text
self-attention over sub-sentences, multi-scale deformable vision attention),
language-guided two-stage query selection (the top num_queries encoder
positions by their best text logit), and a 6-layer decoder with iterative
box refinement and contrastive (vision . text) class logits. Module and
parameter names follow the JAX tree (models/convert.py:grounding_dino_from_jax).

No part of it is a Pallas kernel in the JAX package, and none is a kernel
here: deformable sampling is a plain gather (`grid_sample_zeros_quad`, one
row gather per sample from a 2x2-pixel layout, the attention weight folded
into the bilinear contraction, levels accumulated), attention is plain
matrix products with fp32 logits. Like the JAX model it assumes an
un-padded pixel mask (valid_ratios == 1). Both top-k selections break ties
by the lowest index, as jax.lax.top_k does (ops/knn.py:topk_lowest_index).

Tracing (utils/timing.py) sees the forward as `gdino.text` (BERT and its
projection), `gdino.backbone` (Swin, the input projections and GroupNorms),
`gdino.encoder` (one `gdino.deform` per layer inside), `gdino.select` (the
two-stage top-k, `QuerySelect`) and `gdino.decoder` (one `gdino.deform` per
layer), and counts `gdino.images`, `gdino.tokens` (encoder positions), `gdino.queries`
and `gdino.deform_samples.encoder` / `.decoder` (batch x heads x queries x
levels x points); the detector's host selection waits in
`wait.gdino.scores`.

On a card, under inference mode, the detector replays a forward whose
images, prompt and dtype it has seen before as CUDA graphs
(`_DetectorGraph`, utils/cuda_graphs.py:capture_segmented): the same
kernels in the same order as the eager forward, cut at its spans, which the
replay reopens around the graphs; `gdino.graph_captures` and
`gdino.graph_replays` count them.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freepose_tpu_torch.models.bert import Bert, BertConfig
from freepose_tpu_torch.models.layers import Conv, Dense, GroupNorm, LayerNorm
from freepose_tpu_torch.models.swin import SWIN_B, SwinBackbone, SwinConfig
from freepose_tpu_torch.ops.knn import topk_lowest_index
from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import GraphCache, capture_segmented

# BERT ids of [CLS], [SEP], '.', '?': sub-sentence delimiters.
SPECIAL_TOKENS = (101, 102, 1012, 1029)
# Prompt ids without a WordPiece vocabulary: [CLS] [MASK] '.' [SEP].
PLACEHOLDER_PROMPT_IDS = ((101, 103, 1012, 102),)
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    # Default: grounding-dino-base, Swin-B backbone and BERT-base text.
    swin: SwinConfig = SWIN_B
    text: BertConfig = BertConfig()
    d_model: int = 256
    num_feature_levels: int = 4
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    encoder_ffn: int = 2048
    decoder_ffn: int = 2048
    encoder_points: int = 4
    decoder_points: int = 4
    num_queries: int = 900
    max_text_len: int = 256
    pos_temperature: float = 20.0
    dtype: torch.dtype = torch.float32


GDINO_TEST = GroundingDinoConfig(
    swin=SwinConfig(embed_dim=8, depths=(1, 1, 2), num_heads=(1, 2, 4), window_size=4, out_stages=(1, 2)),
    text=BertConfig(vocab_size=120, hidden_size=24, num_layers=1, num_heads=2, intermediate=48, max_position=32),
    d_model=32, num_feature_levels=3, encoder_layers=1, decoder_layers=2,
    encoder_heads=4, decoder_heads=4, encoder_ffn=64, decoder_ffn=64,
    num_queries=12, max_text_len=16,
)


# --------------------------------------------------------------------------- #
def text_token_masks(input_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sub-sentence self-attention masks [B, T, T] and position ids [B, T]
    from the special tokens (HF generate_masks_with_special_tokens_and_transfer_map)."""
    b, n = input_ids.shape
    special = np.isin(input_ids, SPECIAL_TOKENS)
    attn = np.tile(np.eye(n, dtype=bool)[None], (b, 1, 1))
    pos = np.zeros((b, n), np.int64)
    for row in range(b):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == n - 1:
                attn[row, col, col] = True
                pos[row, col] = 0
            else:
                attn[row, prev + 1 : col + 1, prev + 1 : col + 1] = True
                pos[row, prev + 1 : col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos


def sine_pos_2d(h: int, w: int, dim: int, temperature: float, scale: float = 2 * math.pi,
                device=None) -> torch.Tensor:
    """[h, w, dim] image sine embedding (HF GroundingDinoSinePositionEmbedding
    with an all-ones mask), fp32."""
    half = dim // 2
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (h + 1e-6) * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (w + 1e-6) * scale
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)
    px = x[None, :, None] / dim_t
    py = y[:, None, None] / dim_t
    px = torch.stack([torch.sin(px[..., 0::2]), torch.cos(px[..., 1::2])], -1).reshape(1, w, half)
    py = torch.stack([torch.sin(py[..., 0::2]), torch.cos(py[..., 1::2])], -1).reshape(h, 1, half)
    return torch.cat([py.expand(h, w, half), px.expand(h, w, half)], dim=-1)


def sine_pos_1d(values: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """[...] scalar positions -> [..., dim] fp32 (HF get_sine_pos_embed per
    coordinate: interleaved sin/cos of x·2π/dim_t)."""
    dim_t = torch.arange(dim, dtype=torch.float32, device=values.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / dim)
    s = values.float()[..., None] * (2 * math.pi) / dim_t
    return torch.stack([torch.sin(s[..., 0::2]), torch.cos(s[..., 1::2])], -1).reshape(*values.shape, dim)


def box_sine_embed(ref_points: torch.Tensor, d_model: int) -> torch.Tensor:
    """[..., 4] cxcywh -> [..., 2·d_model]: (y, x) order for the first two
    coordinates (HF get_sine_pos_embed exchange_xy=True), then w, h."""
    half = d_model // 2
    parts = [sine_pos_1d(ref_points[..., i], half) for i in range(ref_points.shape[-1])]
    parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def grid_sample_zeros(value: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """torch.grid_sample(bilinear, zeros, align_corners=False) as four tap
    gathers. value [B, H, W, C]; locs [B, N, 2] in [-1, 1] -> [B, N, C]."""
    b, h, w, c = value.shape
    x = (locs[..., 0] + 1.0) * w / 2.0 - 0.5
    y = (locs[..., 1] + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = value.reshape(b, h * w, c)

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yy = torch.clamp(yy, 0, h - 1).long()
        xx = torch.clamp(xx, 0, w - 1).long()
        vals = torch.gather(flat, 1, (yy * w + xx)[..., None].expand(-1, -1, c))
        return vals * valid[..., None]

    return (tap(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
            + tap(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
            + tap(y0 + 1, x0) * (wy * (1 - wx))[..., None]
            + tap(y0 + 1, x0 + 1) * (wy * wx)[..., None])


def grid_sample_zeros_quad(value: torch.Tensor, locs: torch.Tensor, weight: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """`grid_sample_zeros` with one gather per sample: the map is laid out
    once as a "quad" tensor whose row (i, j) holds pixels (i-1..i, j-1..j),
    4·C channels, with a zero border that gives grid_sample's zero padding;
    the bilinear weights, times an optional per-sample `weight` [B, N] (the
    deformable attention weight), contract the gathered [4, C] block. Sums
    in fp32 when `value` is bf16, as the JAX function's promotion does."""
    b, h, w, c = value.shape
    x = (locs[..., 0] + 1.0) * w / 2.0 - 0.5
    y = (locs[..., 1] + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    p = F.pad(value, (0, 0, 1, 1, 1, 1))
    quad = torch.cat([p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]], dim=-1)
    yi, xi = y0 + 1.0, x0 + 1.0
    inb = (yi >= 0) & (yi <= h) & (xi >= 0) & (xi <= w)
    yi = torch.clamp(yi, 0, h).long()
    xi = torch.clamp(xi, 0, w).long()
    rows = torch.gather(quad.reshape(b, (h + 1) * (w + 1), 4 * c), 1,
                        (yi * (w + 1) + xi)[..., None].expand(-1, -1, 4 * c))
    rows = rows.reshape(*rows.shape[:-1], 4, c)
    w4 = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], dim=-1) * inb[..., None]
    if weight is not None:
        w4 = w4 * weight[..., None]
    return torch.sum(rows * w4[..., None], dim=-2)


@functools.lru_cache(maxsize=16)
def _level_norms(shapes: tuple, device) -> torch.Tensor:
    """[L, 2] (w, h) of each level, on `device`: made once per grid, so a
    graph's capture uploads nothing."""
    return torch.tensor([[wd, ht] for ht, wd in shapes], dtype=torch.float32, device=device)


class MultiScaleDeformableAttention(nn.Module):
    """Deformable attention over flattened multi-level feature maps."""

    def __init__(self, d_model: int, num_heads: int, num_points: int, num_levels: int, dtype: torch.dtype,
                 role: str = "encoder"):
        super().__init__()
        self.d_model, self.num_heads, self.num_points, self.num_levels = d_model, num_heads, num_points, num_levels
        self.role = role  # names its sample counter: gdino.deform_samples.<role>
        self.value_proj = Dense(d_model, d_model, dtype)
        self.sampling_offsets = Dense(d_model, num_heads * num_levels * num_points * 2, dtype)
        self.attention_weights = Dense(d_model, num_heads * num_levels * num_points, dtype)
        self.output_proj = Dense(d_model, d_model, dtype)

    def forward(self, queries, value_states, reference_points, spatial_shapes):
        """queries [B, Q, D] (positions added); value_states [B, S, D];
        reference_points [B, Q, L, 2 or 4] normalised; spatial_shapes: list
        of (h, w)."""
        b, q, _ = queries.shape
        timing.count(f"gdino.deform_samples.{self.role}", b * self.num_heads * q * self.num_levels * self.num_points)
        with timing.span("gdino.deform"):
            return self._sample(queries, value_states, reference_points, spatial_shapes)

    def _sample(self, queries, value_states, reference_points, spatial_shapes):
        c, nh, npts, nl = self.d_model, self.num_heads, self.num_points, self.num_levels
        b, q, _ = queries.shape
        head_dim = c // nh

        value = self.value_proj(value_states).reshape(b, -1, nh, head_dim)
        offsets = self.sampling_offsets(queries).reshape(b, q, nh, nl, npts, 2)
        weights = torch.softmax(self.attention_weights(queries).reshape(b, q, nh, nl * npts), dim=-1)
        weights = weights.reshape(b, q, nh, nl, npts)

        if reference_points.shape[-1] == 2:
            norm = _level_norms(tuple(spatial_shapes), queries.device)
            locs = reference_points[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        else:
            locs = (reference_points[:, :, None, :, None, :2]
                    + offsets / npts * reference_points[:, :, None, :, None, 2:] * 0.5)
        grids = 2.0 * locs - 1.0  # [B, Q, H, L, P, 2]

        # Per level, the attention weight folded into the bilinear
        # contraction; levels accumulated, not stacked.
        start, out = 0, None
        for lvl, (ht, wd) in enumerate(spatial_shapes):
            v = value[:, start : start + ht * wd].permute(0, 2, 1, 3).reshape(b * nh, ht, wd, head_dim)
            g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(b * nh, q * npts, 2)
            aw = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * nh, q * npts)
            s = grid_sample_zeros_quad(v, g, weight=aw)
            s = s.reshape(b, nh, q, npts, head_dim).sum(dim=3)  # [B, H, Q, dh]
            out = s if out is None else out + s
            start += ht * wd
        return self.output_proj(out.permute(0, 2, 1, 3).reshape(b, q, c))


class QuerySelect(nn.Module):
    """The two-stage selection's top-k: (scores, positions) of the `k` best
    encoder positions [B, k], ties to the lowest index. A module of its own,
    so that a forward hook sees the positions it selects."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, scores: torch.Tensor):
        return topk_lowest_index(scores, self.k)


class MHA(nn.Module):
    """Plain multi-head attention (HF GroundingDinoMultiheadAttention)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.q, self.k, self.v = Dense(d_model, d_model, dtype), Dense(d_model, d_model, dtype), \
            Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def forward(self, queries, keys, values, mask=None):
        b, q, _ = queries.shape
        head_dim = self.d_model // self.num_heads

        def heads(x):
            return x.reshape(b, -1, self.num_heads, head_dim).transpose(1, 2)

        qh, kh, vh = heads(self.q(queries)), heads(self.k(keys)), heads(self.v(values))
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (head_dim**-0.5)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(vh.dtype)
        return self.out(torch.matmul(w, vh).transpose(1, 2).reshape(b, q, self.d_model))


class BiMultiHeadAttention(nn.Module):
    """Bidirectional vision-text cross attention (fusion)."""

    def __init__(self, d_model: int, embed_dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.vision_proj = Dense(d_model, embed_dim, dtype)
        self.text_proj = Dense(d_model, embed_dim, dtype)
        self.values_vision_proj = Dense(d_model, embed_dim, dtype)
        self.values_text_proj = Dense(d_model, embed_dim, dtype)
        self.out_vision_proj = Dense(embed_dim, d_model, dtype)
        self.out_text_proj = Dense(embed_dim, d_model, dtype)

    def forward(self, vision, text, text_mask=None):
        b, nv, _ = vision.shape
        nt = text.shape[1]
        head_dim = self.embed_dim // self.num_heads

        def heads(x):
            return x.reshape(b, -1, self.num_heads, head_dim).transpose(1, 2)

        vq = heads(self.vision_proj(vision)) * head_dim**-0.5
        tk = heads(self.text_proj(text))
        vv = heads(self.values_vision_proj(vision))
        tv = heads(self.values_text_proj(text))

        # The JAX order, literally: ONE max over the whole tensor (batch and
        # heads included), the clip, then the per-row max of the transpose.
        logits = torch.matmul(vq.float(), tk.float().transpose(-1, -2))
        logits = torch.clamp(logits - logits.max(), -50000, 50000)
        t_logits = logits.transpose(-1, -2)
        t_logits = torch.clamp(t_logits - t_logits.amax(dim=-1, keepdim=True), -50000, 50000)
        if text_mask is not None:  # [B, T] True = padding
            logits = logits.masked_fill(text_mask[:, None, None, :], -math.inf)
        v_attn = torch.softmax(logits, dim=-1)
        t_attn = torch.softmax(t_logits, dim=-1)

        v_out = torch.matmul(v_attn.to(tv.dtype), tv).transpose(1, 2).reshape(b, nv, self.embed_dim)
        t_out = torch.matmul(t_attn.to(vv.dtype), vv).transpose(1, 2).reshape(b, nt, self.embed_dim)
        return self.out_vision_proj(v_out), self.out_text_proj(t_out)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, num_levels: int):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = cfg
        d = c.d_model
        self.fusion_ln_v, self.fusion_ln_t = LayerNorm(d, dtype=dt), LayerNorm(d, dtype=dt)
        self.fusion_attn = BiMultiHeadAttention(d, c.encoder_ffn // 2, c.encoder_heads // 2, dt)
        self.fusion_vision_scale = nn.Parameter(torch.zeros(d))
        self.fusion_text_scale = nn.Parameter(torch.zeros(d))
        self.text_attn = MHA(d, c.encoder_heads // 2, dt)
        self.text_ln1 = LayerNorm(d, dtype=dt)
        self.text_fc1 = Dense(d, c.encoder_ffn // 2, dt)
        self.text_fc2 = Dense(c.encoder_ffn // 2, d, dt)
        self.text_ln2 = LayerNorm(d, dtype=dt)
        self.deform_attn = MultiScaleDeformableAttention(d, c.encoder_heads, c.encoder_points, num_levels, dt)
        self.deform_ln1 = LayerNorm(d, dtype=dt)
        self.deform_fc1 = Dense(d, c.encoder_ffn, dt)
        self.deform_fc2 = Dense(c.encoder_ffn, d, dt)
        self.deform_ln2 = LayerNorm(d, dtype=dt)

    def forward(self, vision, text, vision_pos, text_pos_ids, text_sa_mask, text_pad_mask,
                reference_points, spatial_shapes):
        # Fusion (pre-LN, layer-scaled residuals).
        v_n, t_n = self.fusion_ln_v(vision), self.fusion_ln_t(text)
        dv, dt = self.fusion_attn(v_n, t_n, text_pad_mask)
        vision = v_n + self.fusion_vision_scale * dv
        text = t_n + self.fusion_text_scale * dt

        # Text enhancer: self attention over sub-sentences, sine position ids.
        t_pos = sine_pos_1d(text_pos_ids.float(), self.cfg.d_model)
        mask = torch.where(text_sa_mask[:, None], 0.0, -math.inf).to(torch.float32)  # [B, 1, T, T]
        q = text + t_pos
        text = self.text_ln1(text + self.text_attn(q, q, text, mask))
        text = self.text_ln2(text + self.text_fc2(F.relu(self.text_fc1(text))))

        # Deformable vision self attention.
        dv = self.deform_attn(vision + vision_pos, vision, reference_points, spatial_shapes)
        vision = self.deform_ln1(vision + dv)
        vision = self.deform_ln2(vision + self.deform_fc2(F.relu(self.deform_fc1(vision))))
        return vision, text


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, num_levels: int):
        super().__init__()
        c, dt, d = cfg, cfg.dtype, cfg.d_model
        self.self_attn = MHA(d, c.decoder_heads, dt)
        self.ln1 = LayerNorm(d, dtype=dt)
        self.text_cross = MHA(d, c.decoder_heads, dt)
        self.ln2 = LayerNorm(d, dtype=dt)
        self.deform_cross = MultiScaleDeformableAttention(d, c.decoder_heads, c.decoder_points, num_levels, dt,
                                                          role="decoder")
        self.ln3 = LayerNorm(d, dtype=dt)
        self.fc1 = Dense(d, c.decoder_ffn, dt)
        self.fc2 = Dense(c.decoder_ffn, d, dt)
        self.ln_out = LayerNorm(d, dtype=dt)

    def forward(self, hidden, query_pos, reference_points_in, vision, text, text_pad_mask, spatial_shapes):
        q = hidden + query_pos
        hidden = self.ln1(hidden + self.self_attn(q, q, hidden))
        mask = torch.where(text_pad_mask[:, None, None, :], -math.inf, 0.0).to(torch.float32)
        hidden = self.ln2(hidden + self.text_cross(hidden + query_pos, text, text, mask))
        attn = self.deform_cross(hidden + query_pos, vision, reference_points_in, spatial_shapes)
        hidden = self.ln3(hidden + attn)
        return self.ln_out(hidden + self.fc2(F.relu(self.fc1(hidden))))


class MLPHead(nn.Module):
    def __init__(self, n_in: int, hidden: int, out: int, layers: int, dtype: torch.dtype):
        super().__init__()
        self.layers = layers
        dims = [n_in] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1], dtype))

    def forward(self, x):
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return getattr(self, f"layer{self.layers - 1}")(x)


def _inv_sigmoid(x, eps=1e-5):
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


class GroundingDino(nn.Module):
    """The detector: (logits [B, Q, max_text_len] fp32, -inf past the text,
    pred_boxes [B, Q, 4] cxcywh in [0, 1] fp32)."""

    def __init__(self, config: GroundingDinoConfig):
        super().__init__()
        c = self.config = config
        d, dt, nl = c.d_model, c.dtype, c.num_feature_levels
        self.text_backbone = Bert(c.text)
        self.text_projection = Dense(c.text.hidden_size, d, dt)
        self.backbone = SwinBackbone(c.swin)
        in_dims = [c.swin.stage_dim(s) for s in c.swin.out_stages]
        for i in range(nl):
            if i < len(in_dims):
                self.add_module(f"input_proj{i}", Conv(in_dims[i], d, 1, dtype=dt))
            else:
                src = in_dims[-1] if i == len(in_dims) else d
                self.add_module(f"input_proj{i}", Conv(src, d, 3, stride=2, padding=1, dtype=dt))
            self.add_module(f"input_gn{i}", GroupNorm(min(32, d), d, dtype=dt))
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        for i in range(c.encoder_layers):
            self.add_module(f"enc{i}", EncoderLayer(c, nl))
        self.enc_output = Dense(d, d, dt)
        self.enc_output_norm = LayerNorm(d, dtype=dt)
        self.enc_bbox_head = MLPHead(d, d, 4, 3, dt)
        self.query_select = QuerySelect(c.num_queries)
        self.query_embeds = nn.Parameter(torch.zeros(c.num_queries, d))
        for i in range(c.decoder_layers):
            self.add_module(f"dec{i}", DecoderLayer(c, nl))
            self.add_module(f"dec_bbox{i}", MLPHead(d, d, 4, 3, dt))
        self.decoder_ln = LayerNorm(d, dtype=dt)
        self.ref_point_head = MLPHead(2 * d, d, d, 2, dt)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor, text_sa_mask: torch.Tensor,
                text_pos_ids: torch.Tensor, text_pad_mask: torch.Tensor):
        c = self.config
        b, dev = pixels.shape[0], pixels.device
        timing.count("gdino.images", b)

        with timing.span("gdino.text"):
            text_raw = self.text_backbone(input_ids, attention_mask=text_sa_mask.int(), position_ids=text_pos_ids)
            text = self.text_projection(text_raw)

        with timing.span("gdino.backbone"):
            stage_feats = self.backbone(pixels)
            feats = []
            for i in range(c.num_feature_levels):
                src = (stage_feats[i] if i < len(stage_feats)
                       else (stage_feats[-1] if i == len(stage_feats) else feats[-1]))
                feats.append(getattr(self, f"input_gn{i}")(getattr(self, f"input_proj{i}")(src)))

        with timing.span("gdino.encoder"):
            spatial_shapes = [(f.shape[1], f.shape[2]) for f in feats]
            flat = torch.cat([f.reshape(b, -1, c.d_model) for f in feats], dim=1)
            timing.count("gdino.tokens", b * flat.shape[1])
            pos = torch.cat([
                (sine_pos_2d(h_, w_, c.d_model, c.pos_temperature, device=dev).reshape(1, -1, c.d_model)
                 + self.level_embed[i][None, None]).to(c.dtype).expand(b, -1, -1)
                for i, (h_, w_) in enumerate(spatial_shapes)
            ], dim=1)

            # Encoder reference points: pixel centres per level, the same on
            # every level (valid_ratios == 1).
            refs, proposals = [], []
            for lvl, (h_, w_) in enumerate(spatial_shapes):
                yy, xx = torch.meshgrid(torch.arange(h_, dtype=torch.float32, device=dev),
                                        torch.arange(w_, dtype=torch.float32, device=dev), indexing="ij")
                grid = torch.stack([(xx.reshape(-1) + 0.5) / w_, (yy.reshape(-1) + 0.5) / h_], -1)
                refs.append(grid)
                proposals.append(torch.cat([grid, torch.full_like(grid, 0.05 * (2.0**lvl))], -1))
            ref_points = torch.cat(refs, 0)[None, :, None, :].expand(b, -1, c.num_feature_levels, -1)

            vision = flat
            for i in range(c.encoder_layers):
                vision, text = getattr(self, f"enc{i}")(vision, text, pos, text_pos_ids, text_sa_mask,
                                                        text_pad_mask, ref_points, spatial_shapes)

        def contrastive(x):
            logits = torch.matmul(x, text.to(x.dtype).transpose(-1, -2)).float()
            logits = logits.masked_fill(text_pad_mask[:, None, :], -math.inf)
            return F.pad(logits, (0, c.max_text_len - logits.shape[-1]), value=-math.inf)

        with timing.span("gdino.select"):
            # Two-stage query selection. An invalid proposal is +inf and its
            # encoder output is zeroed before the matmul, in the JAX order.
            output_proposals = torch.cat(proposals, 0)[None].expand(b, -1, -1)
            valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(-1, keepdim=True)
            output_proposals = torch.where(valid, _inv_sigmoid(output_proposals), math.inf)
            oq = torch.where(valid, vision, torch.zeros((), dtype=vision.dtype, device=dev))
            oq = self.enc_output_norm(self.enc_output(oq))
            enc_logits = contrastive(oq)
            enc_boxes_logits = self.enc_bbox_head(oq) + output_proposals
            topk_scores = torch.where(torch.isfinite(enc_logits), enc_logits, -math.inf).amax(dim=-1)
            _, topk_idx = self.query_select(topk_scores)
            topk_boxes = torch.gather(enc_boxes_logits, 1, topk_idx[..., None].expand(-1, -1, 4))
            reference = torch.sigmoid(topk_boxes)  # [B, Q, 4]

        with timing.span("gdino.decoder"):
            timing.count("gdino.queries", b * c.num_queries)
            hidden = self.query_embeds[None].to(c.dtype).expand(b, -1, -1)
            for i in range(c.decoder_layers):
                ref_in = reference[:, :, None, :].expand(-1, -1, c.num_feature_levels, -1)
                query_pos = self.ref_point_head(box_sine_embed(reference, c.d_model))
                hidden = getattr(self, f"dec{i}")(hidden, query_pos, ref_in, vision, text, text_pad_mask,
                                                  spatial_shapes)
                delta = getattr(self, f"dec_bbox{i}")(self.decoder_ln(hidden))
                reference = torch.sigmoid(delta + _inv_sigmoid(reference))
            return contrastive(self.decoder_ln(hidden)), reference


def prepare_detection_image(image: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, 3] uint8 or float in [0, 1] -> [3, size, size] fp32: bilinear
    resize, then the ImageNet mean and std."""
    from freepose_tpu_torch.ops.sampling import resize_bilinear

    img = image.float()
    if image.dtype == torch.uint8:
        img = img / 255.0
    mean = torch.tensor(IMAGE_MEAN, device=img.device).reshape(3, 1, 1)
    std = torch.tensor(IMAGE_STD, device=img.device).reshape(3, 1, 1)
    return (resize_bilinear(img.permute(2, 0, 1), (size, size)) - mean) / std


def _xyxy_pixels(cxcywh: torch.Tensor, w: float, h: float) -> torch.Tensor:
    return torch.stack([(cxcywh[:, 0] - cxcywh[:, 2] / 2) * w, (cxcywh[:, 1] - cxcywh[:, 3] / 2) * h,
                        (cxcywh[:, 0] + cxcywh[:, 2] / 2) * w, (cxcywh[:, 1] + cxcywh[:, 3] / 2) * h], dim=1)


class _DetectorGraph:
    """One key's forward as CUDA graphs over static inputs (the module's
    docstring). A call copies its inputs in, replays, counts
    `gdino.graph_replays` and returns copies of the static outputs."""

    def __init__(self, model: GroundingDino, batch: torch.Tensor, inputs: list[torch.Tensor]):
        self.batch = batch.clone()
        self.inputs = [t.clone() for t in inputs]

        def step():
            self.out = model(self.batch, *self.inputs)

        self.graph = capture_segmented(batch.device, step, step, cut_exits=("gdino.deform",))
        timing.count("gdino.graph_captures")

    def __call__(self, batch: torch.Tensor, inputs: list[torch.Tensor]):
        self.batch.copy_(batch)
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        timing.count("gdino.graph_replays")
        return tuple(o.clone() for o in self.out)


class GroundingDinoDetector:
    """Detection front end: boxes from a text prompt.

    params: the JAX package's GroundingDino parameter tree (nested dicts of
    numpy arrays), converted by models/convert.py:grounding_dino_from_jax;
    None gives seeded random weights (`random_grounding_dino_params`).
    Prompts are tokenised by a WordPiece vocabulary file when `vocab_path`
    is given; without one, every prompt becomes PLACEHOLDER_PROMPT_IDS, as
    in the JAX detector. Runs on `device` ("cuda" unless the caller asks
    for the CPU)."""

    def __init__(self, config: GroundingDinoConfig, params=None, image_size: int = 800,
                 vocab_path: str | None = None, device=None, seed: int = 0):
        from freepose_tpu_torch.device import resolve_device
        from freepose_tpu_torch.models.convert import grounding_dino_from_jax, random_grounding_dino_params

        self.config = config
        self.device = resolve_device(device)
        self.image_size = image_size
        self.tokenizer = None
        if vocab_path:
            from freepose_tpu_torch.models.wordpiece import WordPieceTokenizer

            self.tokenizer = WordPieceTokenizer(vocab_path)
        if params is None:
            params = random_grounding_dino_params(config, seed=seed)
        model = GroundingDino(config)
        model.load_state_dict(grounding_dino_from_jax(params))
        self.model = model.to(self.device).eval()
        self._graphs = GraphCache()

    @classmethod
    def from_weights(cls, weights_path: str | None, config: GroundingDinoConfig | None = None, device=None):
        """A .npz of JAX-layout params, or seeded random weights for None.
        FREEPOSE_TINY_MODELS=1 picks GDINO_TEST when no config is given."""
        import os

        from freepose_tpu_torch.models.convert import load_params

        cfg = config or (GDINO_TEST if os.environ.get("FREEPOSE_TINY_MODELS") else GroundingDinoConfig())
        return cls(cfg, load_params(weights_path) if weights_path else None, device=device)

    def _prompt_ids(self, input_ids, text: str) -> np.ndarray:
        if input_ids is not None:
            return np.asarray(input_ids)
        if self.tokenizer is not None:
            return np.asarray([self.tokenizer.encode(text)])
        return np.asarray(PLACEHOLDER_PROMPT_IDS)

    def _text_inputs(self, ids: np.ndarray, n: int):
        """Token ids, sub-sentence masks, position ids and the (empty)
        padding mask of a prompt, repeated for `n` images."""
        sa, pos = text_token_masks(ids)
        pad = np.zeros(ids.shape, bool)
        reps = n if ids.shape[0] == 1 else 1
        return [torch.as_tensor(np.repeat(a, reps, axis=0), device=self.device) for a in (ids, sa, pos, pad)]

    @torch.inference_mode()
    def forward_images(self, images, input_ids: np.ndarray | None = None, text: str = "objects."):
        """Images [H, W, 3] (numpy or tensors) sharing one prompt ->
        (logits [N, Q, max_text_len], boxes [N, Q, 4] cxcywh), on the device.
        On a card a key (batch, prompt ids, dtype, device) seen before
        replays its graphs (`_DetectorGraph`)."""
        batch = torch.stack([prepare_detection_image(torch.as_tensor(np.array(img), device=self.device),
                                                      self.image_size) for img in images])
        ids = self._prompt_ids(input_ids, text)
        inputs = self._text_inputs(ids, len(images))
        graph = None
        if batch.device.type == "cuda":
            key = (tuple(batch.shape), ids.shape, ids.tobytes(), self.config.dtype, batch.device)
            graph = self._graphs.get(key, lambda: _DetectorGraph(self.model, batch, inputs))
        return self.model(batch, *inputs) if graph is None else graph(batch, inputs)

    @staticmethod
    def query_scores(logits: torch.Tensor) -> torch.Tensor:
        """Per-query score: the max sigmoid over the finite text logits."""
        return torch.where(torch.isfinite(logits), torch.sigmoid(logits), 0.0).amax(dim=-1)

    def detect(self, image, input_ids: np.ndarray | None = None, text: str = "objects.",
               box_threshold: float = 0.15, text_threshold: float = 0.15):
        """image [H, W, 3] -> (boxes xyxy pixels [N, 4], scores [N]), numpy."""
        return self.detect_batch([image], input_ids, text, box_threshold)[0]

    def detect_batch(self, images, input_ids: np.ndarray | None = None, text: str = "objects.",
                     box_threshold: float = 0.15):
        """Images [H, W, 3] sharing one prompt, one forward -> list of
        (boxes xyxy pixels [N_i, 4], scores [N_i]); only the variable-count
        thresholding runs on the host."""
        logits, boxes = self.forward_images(images, input_ids, text)
        return self.select_boxes(logits, boxes, [img.shape[:2] for img in images], box_threshold)

    def select_boxes(self, logits: torch.Tensor, boxes: torch.Tensor, image_hw, box_threshold):
        """The host selection of `forward_images`' outputs: per image (H, W)
        of `image_hw`, the queries whose score exceeds `box_threshold` ->
        list of (boxes xyxy pixels [N_i, 4], scores [N_i]), numpy. The
        threshold is a number, or a function of an image's query scores
        [Q] (numpy) that returns one."""
        with timing.wait("gdino.scores"):
            all_scores = self.query_scores(logits).cpu().numpy()
            boxes = boxes.cpu()
        out = []
        for i, (h, w) in enumerate(image_hw):
            thr = box_threshold(all_scores[i]) if callable(box_threshold) else box_threshold
            keep = all_scores[i] > thr
            xyxy = (_xyxy_pixels(boxes[i][torch.as_tensor(keep)], w, h).numpy() if keep.any()
                    else np.zeros((0, 4), np.float32))
            out.append((xyxy, all_scores[i][keep]))
        return out

    def detect_topk_device(self, image, k: int = 25, input_ids: np.ndarray | None = None,
                           text: str = "objects."):
        """Fixed-shape detection on the device: (boxes xyxy pixels [k, 4],
        scores [k]) as device tensors, the top-k queries by score (ties to
        the lowest index), low scores carried for the caller to mask."""
        logits, boxes = self.forward_images([image], input_ids, text)
        scores, idx = topk_lowest_index(self.query_scores(logits[0]), k)
        h, w = image.shape[:2]
        return _xyxy_pixels(boxes[0][idx], w, h), scores
