"""GroundingDINO-B, plain, at float32: the reference the BOP cells hold the
program's detector to.

Written from the published description (Liu et al., "Grounding DINO",
arXiv:2303.05499; IDEA-Research/GroundingDINO,
groundingdino/config/GroundingDINO_SwinB_cfg.py and its modules), not from
the program, and importing nothing of it:
  * Swin-B (embed 128, depths 2/2/18/2, heads 4/8/16/32, window 12): a 4x4
    patch embedding, windowed attention with the relative-position bias,
    every odd block's windows shifted by half a window with the -100 mask
    built on the grid padded up to whole windows (the output cropped back),
    2x2 patch merging after padding an odd side, a LayerNorm on each output
    stage (1, 2, 3);
  * BERT-base: word, position and type embeddings, twelve post-LN layers;
    the sub-sentence attention masks and position ids of the prompt's
    special tokens ([CLS], [SEP], '.', '?'), as the release's
    generate_masks_with_special_tokens_and_transfer_map makes them;
  * four feature levels: 1x1 projections of stages 1-3 and a 3x3 stride-2
    one of stage 3, each with GroupNorm(32); the normalised sine position
    embedding at temperature 20 plus a level embedding;
  * six encoder layers of: the vision-text fusion (both inputs
    layer-normed, one attention of 4 heads 1,024 wide in both directions
    with the release's stabilised logits, residuals scaled per channel), the
    text enhancer (self-attention over the sub-sentences with sine position
    ids, post-LN, FFN 1,024), deformable self-attention (8 heads, 4 levels,
    4 points, sampled as the release's multi_scale_deformable_attn_pytorch
    does: F.grid_sample, bilinear, zeros, align_corners=False), post-LN, FFN
    2,048;
  * the two-stage selection: the encoder proposals (pixel centres, sides
    0.05·2^level, invalid outside (0.01, 0.99)), the top 900 positions by
    their best text logit, their box logits as the first references;
  * six decoder layers (self-attention, text cross-attention, deformable
    cross-attention, FFN, each post-LN) with iterative box refinement, the
    box head one MLP shared by the six layers (decoder_bbox_embed_share);
    contrastive logits (hidden . text) padded to 256 tokens with -inf.

Departures shared with the program (each the JAX package's):
  * the image is resized to a square 800² (the release keeps the aspect at
    a short side of 800, at most 1,333);
  * without a WordPiece vocabulary the prompt "objects." is the
    placeholder ids [CLS] [MASK] '.' [SEP] (4 tokens, as "objects." is under
    BERT's vocabulary);
  * the pixel mask is unpadded (every valid ratio 1);
  * between decoder layers the box head refines from the layer-normed
    hidden state (the release reads the layer's output before the decoder's
    norm, and normalises only what it outputs; the final boxes agree).
  * the transformer's LayerNorms and GroupNorms take epsilon 1e-6 (Flax's
    default; the release's are torch's 1e-5). Swin's are 1e-5 and BERT's
    1e-12, as released.

Where the program chose (its 900 positions), `forward(..., follow=)` takes
the program's choice, and the comparison measures how far the reference's
own choice stood from it. Products run through `frozen.attention.mm`, so
the float8 control (reference/control.py) quantises them too. The
parameters carry the program's names, so one set of seeded weights loads
into both (the program keeps six copies of the shared box head)."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.frozen.attention import mm

EPS = 1e-6  # the transformer's norms (a departure shared with the program)
SPECIAL_TOKENS = (101, 102, 1012, 1029)  # [CLS], [SEP], '.', '?'
PLACEHOLDER_IDS = (101, 103, 1012, 102)
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 128
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window_size: int = 12
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_stages: tuple = (1, 2, 3)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    swin: SwinConfig = SwinConfig()
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


def config_from(group: dict) -> GroundingDinoConfig:
    """The configuration file's "grounding_dino" group -> a config."""
    def pick(cls, values):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: tuple(v) if isinstance(v, list) else v for k, v in values.items() if k in names}

    return GroundingDinoConfig(swin=SwinConfig(**pick(SwinConfig, group["swin"])),
                               text=BertConfig(**pick(BertConfig, group["text"])),
                               **pick(GroundingDinoConfig, group["transformer"]))


# ----------------------------------------------------------------- text
def text_masks(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, T] token ids -> (self-attention mask [B, T, T] bool, position ids
    [B, T]): each sub-sentence between two special tokens attends to itself,
    its positions counted from 0 after the opening token (which closes the
    previous one); the first and last tokens attend to themselves alone."""
    b, n = ids.shape
    attn = np.zeros((b, n, n), bool)
    pos = np.zeros((b, n), np.int64)
    for row in range(b):
        attn[row][np.arange(n), np.arange(n)] = True
        specials = [c for c in range(n) if ids[row, c] in SPECIAL_TOKENS]
        prev = 0
        for col in specials:
            if col not in (0, n - 1):
                attn[row, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[row, prev + 1:col + 1] = np.arange(col - prev)
            prev = col
    return attn, pos


def sine_1d(x: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """[...] -> [..., dim]: sin and cos of x·2π over temperature^(2⌊i/2⌋/dim),
    interleaved (the release's get_sine_pos_embed)."""
    i = torch.arange(dim, dtype=torch.float32, device=x.device)
    t = temperature ** (2 * (i // 2) / dim)
    a = x.float()[..., None] * 2 * math.pi / t
    return torch.stack([a[..., 0::2].sin(), a[..., 1::2].cos()], dim=-1).flatten(-2)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        h = c.hidden_size
        self.heads = c.num_heads
        self.q, self.k, self.v, self.attn_out = (nn.Linear(h, h) for _ in range(4))
        self.attn_ln = nn.LayerNorm(h, eps=1e-12)
        self.fc1, self.fc2 = nn.Linear(h, c.intermediate), nn.Linear(c.intermediate, h)
        self.out_ln = nn.LayerNorm(h, eps=1e-12)

    def forward(self, x, allowed):
        b, n, h = x.shape
        d = h // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        logits = logits.masked_fill(~allowed[:, None], -math.inf)
        ctx = mm(logits.softmax(-1), v).transpose(1, 2).reshape(b, n, h)
        x = self.attn_ln(x + self.attn_out(ctx))
        return self.out_ln(x + self.fc2(F.gelu(self.fc1(x))))


class Bert(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Parameter(torch.zeros(c.vocab_size, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(c.max_position, c.hidden_size))
        self.token_type_embeddings = nn.Parameter(torch.zeros(c.type_vocab, c.hidden_size))
        self.embed_ln = nn.LayerNorm(c.hidden_size, eps=1e-12)
        self.n_layers = c.num_layers
        for i in range(c.num_layers):
            self.add_module(f"layer{i}", BertLayer(c))

    def forward(self, ids, allowed, pos_ids):
        x = self.word_embeddings[ids] + self.position_embeddings[pos_ids] + self.token_type_embeddings[0]
        x = self.embed_ln(x)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, allowed)
        return x


# ----------------------------------------------------------------- Swin
def windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B·nW, ws², C]."""
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def unwindows(x: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    return x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_index(ws: int) -> torch.Tensor:
    """[ws², ws²] index into the (2ws-1)² bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """[nW, ws², ws²]: -100 between positions of different regions of the
    shifted padded grid, else 0."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl] = cnt
            cnt += 1
    win = windows(img, ws)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.heads, self.ws, self.shift = heads, ws, shift
        self.ln1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim)
        self.fc1, self.fc2 = nn.Linear(dim, int(dim * mlp_ratio)), nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        short = x
        x = self.ln1(x)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = windows(x, ws)
        n, d = ws * ws, c // self.heads
        qkv = self.qkv(xw).reshape(-1, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] / math.sqrt(d), qkv[1], qkv[2]
        attn = mm(q, k.transpose(-1, -2))
        bias = self.rel_bias_table[relative_index(ws).to(x.device).reshape(-1)].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1)[None]
        if shift:
            mask = shift_mask(hp, wp, ws, shift, x.device)
            attn = (attn.reshape(b, mask.shape[0], self.heads, n, n) + mask[None, :, None]).reshape(-1, self.heads,
                                                                                                 n, n)
        out = mm(attn.softmax(-1), v).transpose(1, 2).reshape(-1, n, c)
        x = unwindows(self.proj(out), ws, b, hp, wp)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = short + x[:, :h, :w]
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class Swin(nn.Module):
    def __init__(self, c: SwinConfig):
        super().__init__()
        self.c = c
        self.patch_embed = nn.Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size)
        self.embed_norm = nn.LayerNorm(c.embed_dim)
        for s, depth in enumerate(c.depths):
            dim = c.embed_dim * 2 ** s
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", SwinBlock(dim, c.num_heads[s], c.window_size,
                                                                 c.window_size // 2 if i % 2 else 0, c.mlp_ratio))
            if s in c.out_stages:
                self.add_module(f"out_norm{s}", nn.LayerNorm(dim))
            if s + 1 < len(c.depths):
                self.add_module(f"downsample{s}", PatchMerging(dim))

    def forward(self, pixels):
        """[B, 3, H, W] -> the out stages' maps [B, H_s, W_s, C_s]."""
        x = self.embed_norm(self.patch_embed(pixels).permute(0, 2, 3, 1))
        outs = []
        for s, depth in enumerate(self.c.depths):
            for i in range(depth):
                x = getattr(self, f"stage{s}_block{i}")(x)
            if s in self.c.out_stages:
                outs.append(getattr(self, f"out_norm{s}")(x))
            if s + 1 < len(self.c.depths):
                x = getattr(self, f"downsample{s}")(x)
        return outs


# ----------------------------------------------------------------- transformer
def deformable_sample(value: torch.Tensor, shapes, locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The release's multi_scale_deformable_attn_pytorch: value [B, S, H,
    d], shapes [(h, w)] per level, locations [B, Q, H, L, P, 2] in [0, 1],
    weights [B, Q, H, L, P] -> [B, Q, H·d]."""
    b, _, nh, d = value.shape
    _, q, _, nl, npts, _ = locations.shape
    grids = 2 * locations - 1
    sampled, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].flatten(2).transpose(1, 2).reshape(b * nh, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # [B·H, Q, P, 2]
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
        start += h * w
    aw = weights.transpose(1, 2).reshape(b * nh, 1, q, nl * npts)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * aw).sum(-1)  # [B·H, d, Q]
    return out.reshape(b, nh * d, q).transpose(1, 2)


class MultiScaleDeformableAttention(nn.Module):
    def __init__(self, d: int, heads: int, levels: int, points: int):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, value, ref, shapes):
        """query [B, Q, D]; value [B, S, D]; ref [B, Q, L, 2 or 4] in [0, 1]."""
        b, q, d = query.shape
        nh, nl, npts = self.heads, self.levels, self.points
        v = self.value_proj(value).reshape(b, -1, nh, d // nh)
        off = self.sampling_offsets(query).reshape(b, q, nh, nl, npts, 2)
        aw = self.attention_weights(query).reshape(b, q, nh, nl * npts).softmax(-1).reshape(b, q, nh, nl, npts)
        if ref.shape[-1] == 2:
            norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=query.device)
            loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        else:
            loc = ref[:, :, None, :, None, :2] + off / npts * ref[:, :, None, :, None, 2:] * 0.5
        return self.output_proj(deformable_sample(v, shapes, loc, aw))


class MHA(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.out = (nn.Linear(d, d) for _ in range(4))

    def forward(self, q_in, k_in, v_in, allowed=None):
        b, nq, d = q_in.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        logits = mm(split(self.q(q_in)), split(self.k(k_in)).transpose(-1, -2)) / math.sqrt(hd)
        if allowed is not None:
            logits = logits.masked_fill(~allowed, -math.inf)
        return self.out(mm(logits.softmax(-1), split(self.v(v_in))).transpose(1, 2).reshape(b, nq, d))


class BiAttention(nn.Module):
    """The release's BiMultiHeadAttention (stable_softmax_2d, both clamps)."""

    def __init__(self, d: int, embed: int, heads: int):
        super().__init__()
        self.embed, self.heads = embed, heads
        self.vision_proj, self.text_proj = nn.Linear(d, embed), nn.Linear(d, embed)
        self.values_vision_proj, self.values_text_proj = nn.Linear(d, embed), nn.Linear(d, embed)
        self.out_vision_proj, self.out_text_proj = nn.Linear(embed, d), nn.Linear(embed, d)

    def forward(self, v, t):
        b, nv, _ = v.shape
        nt = t.shape[1]
        hd = self.embed // self.heads

        def split(x):
            return x.reshape(b, -1, self.heads, hd).transpose(1, 2)

        q = split(self.vision_proj(v)) / math.sqrt(hd)
        k, vv, tv = split(self.text_proj(t)), split(self.values_vision_proj(v)), split(self.values_text_proj(t))
        w = mm(q, k.transpose(-1, -2))  # [B, heads, Nv, Nt]
        w = (w - w.max()).clamp(-50000, 50000)
        wt = w.transpose(-1, -2)
        wt = (wt - wt.amax(-1, keepdim=True)).clamp(-50000, 50000)
        out_v = mm(w.softmax(-1), tv).transpose(1, 2).reshape(b, nv, self.embed)
        out_t = mm(wt.softmax(-1), vv).transpose(1, 2).reshape(b, nt, self.embed)
        return self.out_vision_proj(out_v), self.out_text_proj(out_t)


class EncoderLayer(nn.Module):
    def __init__(self, c: GroundingDinoConfig):
        super().__init__()
        d = c.d_model
        self.d = d
        self.fusion_ln_v, self.fusion_ln_t = nn.LayerNorm(d, eps=EPS), nn.LayerNorm(d, eps=EPS)
        self.fusion_attn = BiAttention(d, c.encoder_ffn // 2, c.encoder_heads // 2)
        self.fusion_vision_scale = nn.Parameter(torch.zeros(d))
        self.fusion_text_scale = nn.Parameter(torch.zeros(d))
        self.text_attn = MHA(d, c.encoder_heads // 2)
        self.text_ln1, self.text_ln2 = nn.LayerNorm(d, eps=EPS), nn.LayerNorm(d, eps=EPS)
        self.text_fc1, self.text_fc2 = nn.Linear(d, c.encoder_ffn // 2), nn.Linear(c.encoder_ffn // 2, d)
        self.deform_attn = MultiScaleDeformableAttention(d, c.encoder_heads, c.num_feature_levels, c.encoder_points)
        self.deform_ln1, self.deform_ln2 = nn.LayerNorm(d, eps=EPS), nn.LayerNorm(d, eps=EPS)
        self.deform_fc1, self.deform_fc2 = nn.Linear(d, c.encoder_ffn), nn.Linear(c.encoder_ffn, d)

    def forward(self, vision, text, pos, text_pos, allowed, ref, shapes):
        v, t = self.fusion_ln_v(vision), self.fusion_ln_t(text)
        dv, dt = self.fusion_attn(v, t)
        v, t = v + self.fusion_vision_scale * dv, t + self.fusion_text_scale * dt
        q = t + sine_1d(text_pos, self.d)
        t = self.text_ln1(t + self.text_attn(q, q, t, allowed[:, None]))
        t = self.text_ln2(t + self.text_fc2(F.relu(self.text_fc1(t))))
        v = self.deform_ln1(v + self.deform_attn(v + pos, v, ref, shapes))
        v = self.deform_ln2(v + self.deform_fc2(F.relu(self.deform_fc1(v))))
        return v, t


class DecoderLayer(nn.Module):
    def __init__(self, c: GroundingDinoConfig):
        super().__init__()
        d = c.d_model
        self.self_attn, self.text_cross = MHA(d, c.decoder_heads), MHA(d, c.decoder_heads)
        self.deform_cross = MultiScaleDeformableAttention(d, c.decoder_heads, c.num_feature_levels, c.decoder_points)
        self.ln1, self.ln2, self.ln3, self.ln_out = (nn.LayerNorm(d, eps=EPS) for _ in range(4))
        self.fc1, self.fc2 = nn.Linear(d, c.decoder_ffn), nn.Linear(c.decoder_ffn, d)

    def forward(self, hidden, qpos, ref, memory, text, shapes):
        q = hidden + qpos
        hidden = self.ln1(hidden + self.self_attn(q, q, hidden))
        hidden = self.ln2(hidden + self.text_cross(hidden + qpos, text, text))
        hidden = self.ln3(hidden + self.deform_cross(hidden + qpos, memory, ref, shapes))
        return self.ln_out(hidden + self.fc2(F.relu(self.fc1(hidden))))


class MLP(nn.Module):
    def __init__(self, n_in: int, hidden: int, out: int, layers: int):
        super().__init__()
        self.n = layers
        dims = [n_in] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return getattr(self, f"layer{self.n - 1}")(x)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def sine_2d(h: int, w: int, d: int, temperature: float, device) -> torch.Tensor:
    """[h·w, d]: the normalised sine embedding of an unpadded map, (y, x)."""
    y = (torch.arange(h, device=device, dtype=torch.float32) + 1) / (h + 1e-6) * 2 * math.pi
    x = (torch.arange(w, device=device, dtype=torch.float32) + 1) / (w + 1e-6) * 2 * math.pi
    half = d // 2
    py = sine_1d(y / (2 * math.pi), half, temperature)[:, None].expand(h, w, half)
    px = sine_1d(x / (2 * math.pi), half, temperature)[None].expand(h, w, half)
    return torch.cat([py, px], dim=-1).reshape(h * w, d)


class GroundingDino(nn.Module):
    def __init__(self, c: GroundingDinoConfig):
        super().__init__()
        self.c = c
        d, nl = c.d_model, c.num_feature_levels
        self.text_backbone = Bert(c.text)
        self.text_projection = nn.Linear(c.text.hidden_size, d)
        self.backbone = Swin(c.swin)
        dims = [c.swin.embed_dim * 2 ** s for s in c.swin.out_stages]
        for i in range(nl):
            conv = (nn.Conv2d(dims[i], d, 1) if i < len(dims)
                    else nn.Conv2d(dims[-1] if i == len(dims) else d, d, 3, stride=2, padding=1))
            self.add_module(f"input_proj{i}", conv)
            self.add_module(f"input_gn{i}", nn.GroupNorm(32 if d >= 32 else d, d, eps=EPS))
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        for i in range(c.encoder_layers):
            self.add_module(f"enc{i}", EncoderLayer(c))
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=EPS)
        self.enc_bbox_head = MLP(d, d, 4, 3)
        self.query_embeds = nn.Parameter(torch.zeros(c.num_queries, d))
        for i in range(c.decoder_layers):
            self.add_module(f"dec{i}", DecoderLayer(c))
        self.dec_bbox = MLP(d, d, 4, 3)
        self.decoder_ln = nn.LayerNorm(d, eps=EPS)
        self.ref_point_head = MLP(2 * d, d, d, 2)

    def _contrastive(self, x, text):
        logits = mm(x, text.transpose(-1, -2))
        return F.pad(logits, (0, self.c.max_text_len - logits.shape[-1]), value=-math.inf)

    @torch.inference_mode()
    def forward(self, pixels: torch.Tensor, ids: np.ndarray, follow: torch.Tensor | None = None) -> dict:
        """pixels [B, 3, S, S] normalised; ids [B, T] token ids (numpy).
        `follow` [B, Q]: the positions to select in place of the reference's
        own top Q. -> {"memory" [B, S, D] (the encoder's output), "scores" [B,
        S] (each position's best text logit), "own_select" [B, Q] (the
        reference's top Q), "select" [B, Q] (the positions decoded),
        "hidden" [B, Q, D] (the last decoder layer's output), "logits" [B, Q,
        max_text_len], "boxes" [B, Q, 4] cxcywh in [0, 1]}."""
        c, dev = self.c, pixels.device
        b = pixels.shape[0]
        allowed_np, pos_np = text_masks(np.asarray(ids))
        allowed = torch.as_tensor(allowed_np, device=dev)
        text_pos = torch.as_tensor(pos_np, device=dev)
        ids_t = torch.as_tensor(np.asarray(ids), device=dev)
        text = self.text_projection(self.text_backbone(ids_t, allowed, text_pos))

        stages = self.backbone(pixels)
        feats = []
        for i in range(c.num_feature_levels):
            src = stages[i] if i < len(stages) else (stages[-1] if i == len(stages) else feats[-1])
            x = getattr(self, f"input_proj{i}")(src.permute(0, 3, 1, 2))
            feats.append(getattr(self, f"input_gn{i}")(x).permute(0, 2, 3, 1))
        shapes = [tuple(f.shape[1:3]) for f in feats]
        memory = torch.cat([f.reshape(b, -1, c.d_model) for f in feats], dim=1)
        pos = torch.cat([sine_2d(h, w, c.d_model, c.pos_temperature, dev) + self.level_embed[i]
                         for i, (h, w) in enumerate(shapes)])[None]
        centres, props = [], []
        for lvl, (h, w) in enumerate(shapes):
            yy, xx = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, device=dev),
                                    torch.linspace(0.5, w - 0.5, w, device=dev), indexing="ij")
            ctr = torch.stack([xx.reshape(-1) / w, yy.reshape(-1) / h], -1)
            centres.append(ctr)
            props.append(torch.cat([ctr, torch.full_like(ctr, 0.05 * 2.0 ** lvl)], -1))
        ref = torch.cat(centres)[None, :, None].expand(b, -1, c.num_feature_levels, -1)
        for i in range(c.encoder_layers):
            memory, text = getattr(self, f"enc{i}")(memory, text, pos, text_pos, allowed, ref, shapes)

        proposals = torch.cat(props)[None].expand(b, -1, -1)
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        prop_logits = torch.where(valid, inverse_sigmoid(proposals, eps=0.0), math.inf)
        out_mem = self.enc_output_norm(self.enc_output(torch.where(valid, memory, 0.0)))
        scores = self._contrastive(out_mem, text).amax(-1)
        box_logits = self.enc_bbox_head(out_mem) + prop_logits
        own = torch.topk(scores, c.num_queries, dim=1).indices
        select = own if follow is None else follow.to(dev).long()
        reference = torch.gather(box_logits, 1, select[..., None].expand(-1, -1, 4)).sigmoid()

        hidden = self.query_embeds[None].expand(b, -1, -1)
        for i in range(c.decoder_layers):
            qpos = self.ref_point_head(torch.cat([sine_1d(reference[..., j], c.d_model // 2)
                                                  for j in (1, 0, 2, 3)], -1))
            hidden = getattr(self, f"dec{i}")(hidden, qpos, reference[:, :, None].expand(-1, -1, c.num_feature_levels,
                                                                                          -1), memory, text, shapes)
            reference = (self.dec_bbox(self.decoder_ln(hidden)) + inverse_sigmoid(reference)).sigmoid()
        return {"memory": memory, "scores": scores, "own_select": own, "select": select, "hidden": hidden,
                "logits": self._contrastive(self.decoder_ln(hidden), text), "boxes": reference}


def prepare(image: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, 3] uint8 -> [1, 3, size, size]: a square bilinear resize
    (F.interpolate, align_corners=False), then the ImageNet mean and std."""
    img = image.permute(2, 0, 1)[None].float() / 255.0
    img = F.interpolate(img, size=(size, size), mode="bilinear", align_corners=False)
    mean = torch.tensor(IMAGE_MEAN, device=img.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGE_STD, device=img.device).reshape(1, 3, 1, 1)
    return (img - mean) / std


def query_scores(logits: torch.Tensor) -> torch.Tensor:
    """Per query: the largest sigmoid over the prompt's tokens."""
    return torch.where(torch.isfinite(logits), logits.sigmoid(), 0.0).amax(-1)


def xyxy(boxes: torch.Tensor, w: float, h: float) -> torch.Tensor:
    """cxcywh in [0, 1] -> xyxy pixels."""
    cx, cy, bw, bh = boxes.unbind(-1)
    return torch.stack([(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], -1)
