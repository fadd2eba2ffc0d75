"""CoTracker2, plain: the released point tracker (facebookresearch/co-tracker
v2.0, cotracker/models/core/cotracker/cotracker.py and
cotracker/predictor.py; Karaev et al., arXiv:2307.07635) written from its
description in float32 torch, with no kernel, no cache and no batching
trick. The caller turns TF32 off (models.full_fp32), so every product is
an fp32 one.

  - BasicEncoder `fnet`: a 7x7 stride-2 stem and 4 stages of two residual
    blocks (F.conv2d, F.instance_norm without affine parameters), each
    stage resized to stride 4 (F.interpolate, bilinear, align_corners) and
    fused by a 3x3 and a 1x1 convolution.
  - Each iteration correlates the track features with the full correlation
    volume of each of 4 average-pooled levels ([S·N, 1, H/2^l, W/2^l]) and
    samples a (2r+1)² unit-spaced window around each track with
    F.grid_sample (align_corners, border padding), the x offset varying
    slowest.
  - The EfficientUpdateFormer: [N + 64 virtual, S, 384] tokens; 6 blocks of
    attention over time, each followed by a space step (virtual <- point
    cross-attention, virtual self-attention, point <- virtual
    cross-attention). Attention is softmax(q·kᵀ/√d + bias)·v, written out,
    the bias -finfo.max on masked logits as the release adds it.
  - Windows of 8 frames, step 4; a window after the first starts its first
    4 frames from the previous window's predictions and repeats the last of
    them for the rest. Then the predictor: the video resized to the model
    resolution, a 6x6 support grid on frame 0, visibility above 0.9, the
    query frames pinned, the tracks scaled back.

Departures from the release, each shared with the measured program:
  - one video at a time (no batch dimension), and no backward pass: every
    query of the smooth stage sits on the interval's first frame, where
    the release's backward pass changes nothing;
  - the query features and the position embedding are sampled with zero
    padding (F.grid_sample's "zeros"), the correlation windows with border
    padding;
  - the parameters are those the benchmark draws from the seed
    (benchmark/weights.py) in the released checkpoint's key layout
    (fnet.*, updateformer.* with its `virual_tracks` spelling, norm,
    track_feat_updater.0, vis_predictor.0), not the released weights.

`matmul`, F.linear and F.conv2d carry every product; the control
(smooth_check.tf32_products) rounds their operands."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

VISIBILITY_THRESHOLD = 0.9


@dataclass(frozen=True)
class CoTracker2Config:
    latent_dim: int = 128
    stride: int = 4
    window_len: int = 8
    corr_levels: int = 4
    corr_radius: int = 3
    flow_emb_dim: int = 64
    hidden_size: int = 384
    num_heads: int = 8
    depth: int = 6
    num_virtual_tracks: int = 64
    model_resolution: tuple = (384, 512)
    iters: int = 6

    @property
    def input_dim(self) -> int:
        d = 2 * self.corr_radius + 1
        return (2 * self.flow_emb_dim + 2) + self.corr_levels * d * d + self.latent_dim + 2


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


# ------------------------------------------------------------------ embeddings
def sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """[M] positions -> [M, dim]: sin(pos·ω) then cos(pos·ω), ω_i =
    10000^(-i / (dim/2)), computed in float64."""
    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0))
    out = pos.reshape(-1).to(torch.float64)[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1).to(torch.float32)


def pos_embedding_2d(dim: int, h: int, w: int) -> torch.Tensor:
    """[dim, h, w]: the first half of the channels embeds x, the second y."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float64), torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    emb = torch.cat([sincos_1d(dim // 2, gx), sincos_1d(dim // 2, gy)], dim=1)
    return emb.reshape(h, w, dim).permute(2, 0, 1)


def flow_embedding(xy: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., 2] -> [..., 2·dim + 2]: xy, then sin and cos of x at the
    frequencies k·1000/dim interleaved, then those of y."""
    freqs = torch.arange(0, dim, 2, dtype=torch.float32, device=xy.device) * (1000.0 / dim)
    parts = [xy]
    for c in range(2):
        a = xy[..., c:c + 1] * freqs
        parts.append(torch.stack([torch.sin(a), torch.cos(a)], dim=-1).reshape(*xy.shape[:-1], dim))
    return torch.cat(parts, dim=-1)


# ------------------------------------------------------------------ sampling
def grid_points(points: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel positions (x, y) -> grid_sample's [-1, 1] with align_corners."""
    scale = torch.tensor([2.0 / max(w - 1, 1), 2.0 / max(h - 1, 1)], device=points.device)
    return points * scale - 1.0


def sample_points(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """fmap [C, H, W], xy [N, 2] -> [N, C], bilinear, zero padding."""
    c, h, w = fmap.shape
    out = F.grid_sample(fmap[None], grid_points(xy, h, w)[None, :, None], mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[0, :, :, 0].T


def correlation_windows(vol: torch.Tensor, centers: torch.Tensor, radius: int) -> torch.Tensor:
    """vol [M, H, W] (one correlation map per track and frame), centers [M,
    2] (x, y) -> [M, (2r+1)²]: the window's unit-spaced samples, border
    padding, the x offset varying slowest."""
    m, h, w = vol.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=vol.device)
    ox, oy = torch.meshgrid(offs, offs, indexing="ij")  # [d, d]: x offset along the first axis
    pts = centers[:, None, None, :] + torch.stack([ox, oy], dim=-1)[None]
    out = F.grid_sample(vol[:, None], grid_points(pts, h, w), mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out.reshape(m, -1)


# ------------------------------------------------------------------ the encoder
class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride)) if stride != 1 else None

    def forward(self, x):
        y = F.relu(F.instance_norm(F.conv2d(x, self.conv1.weight, self.conv1.bias, self.stride, 1), eps=1e-5))
        y = F.relu(F.instance_norm(F.conv2d(y, self.conv2.weight, self.conv2.bias, 1, 1), eps=1e-5))
        if self.downsample is not None:
            d = self.downsample[0]
            x = F.instance_norm(F.conv2d(x, d.weight, d.bias, self.stride), eps=1e-5)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """[T, 3, H, W] in [-1, 1] -> [T, latent, H/stride, W/stride]."""

    def __init__(self, d: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(3, d // 2, 7, stride=2, padding=3)
        dims, in_planes = (d // 2, d // 4 * 3, d, d), d // 2
        for i, (dim, s) in enumerate(zip(dims, (1, 2, 2, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(ResidualBlock(in_planes, dim, s), ResidualBlock(dim, dim)))
            in_planes = dim
        self.conv2 = nn.Conv2d(sum(dims), d * 2, 3, padding=1)
        self.conv3 = nn.Conv2d(d * 2, d, 1)

    def forward(self, x):
        hw = (x.shape[2] // self.stride, x.shape[3] // self.stride)
        x = F.relu(F.instance_norm(F.conv2d(x, self.conv1.weight, self.conv1.bias, 2, 3), eps=1e-5))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x)
            feats.append(F.interpolate(x, size=hw, mode="bilinear", align_corners=True))
        x = F.relu(F.instance_norm(F.conv2d(torch.cat(feats, dim=1), self.conv2.weight, self.conv2.bias, 1, 1),
                                   eps=1e-5))
        return F.conv2d(x, self.conv3.weight, self.conv3.bias)


# ------------------------------------------------------------------ the update former
def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight, layer.bias)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_kv = nn.Linear(dim, 2 * dim)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, context=None, masked=None):
        """x [B, Nq, D], context [B, Nk, D]; masked: bool broadcastable to
        the logits [B, heads, Nq, Nk], True where a logit is masked out."""
        ctx = x if context is None else context
        b, nq, dim = x.shape
        h, hd = self.heads, dim // self.heads
        q = linear(self.to_q, x).reshape(b, nq, h, hd).permute(0, 2, 1, 3)
        k, v = linear(self.to_kv, ctx).chunk(2, dim=-1)
        k = k.reshape(b, -1, h, hd).permute(0, 2, 1, 3)
        v = v.reshape(b, -1, h, hd).permute(0, 2, 1, 3)
        logits = matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        if masked is not None:
            logits = logits + masked.to(logits.dtype) * -torch.finfo(logits.dtype).max
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        out = matmul(p, v).permute(0, 2, 1, 3).reshape(b, nq, dim)
        return linear(self.to_out, out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(self.fc2, F.gelu(linear(self.fc1, x), approximate="tanh"))


class AttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn = Attention(dim, heads)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(layer_norm(x))
        return x + self.mlp(layer_norm(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm_context = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = Attention(dim, heads)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, context, masked=None):
        ctx = F.layer_norm(context, context.shape[-1:], self.norm_context.weight, self.norm_context.bias, 1e-5)
        x = x + self.cross_attn(layer_norm(x), ctx, masked)
        return x + self.mlp(layer_norm(x))


class EfficientUpdateFormer(nn.Module):
    def __init__(self, cfg: CoTracker2Config):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        self.num_virtual = cfg.num_virtual_tracks
        self.input_transform = nn.Linear(cfg.input_dim, d)
        self.flow_head = nn.Linear(d, cfg.latent_dim + 2)
        self.virual_tracks = nn.Parameter(torch.zeros(1, cfg.num_virtual_tracks, 1, d))
        self.time_blocks = nn.ModuleList(AttnBlock(d, h) for _ in range(cfg.depth))
        self.space_virtual_blocks = nn.ModuleList(AttnBlock(d, h) for _ in range(cfg.depth))
        self.space_point2virtual_blocks = nn.ModuleList(CrossAttnBlock(d, h) for _ in range(cfg.depth))
        self.space_virtual2point_blocks = nn.ModuleList(CrossAttnBlock(d, h) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, exists: torch.Tensor) -> torch.Tensor:
        """x [N, S, input_dim], exists [S, N] bool -> [N, S, latent + 2]."""
        n, s = x.shape[:2]
        v = self.num_virtual
        tokens = torch.cat([linear(self.input_transform, x), self.virual_tracks[0].expand(v, s, -1)], dim=0)
        absent = ~exists  # [S, N]
        for j in range(len(self.time_blocks)):
            tokens = self.time_blocks[j](tokens)  # attention over the S frames of each token
            space = tokens.transpose(0, 1)  # [S, N + V, D]: attention within each frame
            points, virtual = space[:, :n], space[:, n:]
            virtual = self.space_virtual2point_blocks[j](virtual, points, absent[:, None, None, :])
            virtual = self.space_virtual_blocks[j](virtual)
            points = self.space_point2virtual_blocks[j](points, virtual, absent[:, None, :, None])
            tokens = torch.cat([points, virtual], dim=1).transpose(0, 1)
        return linear(self.flow_head, tokens[:n])


# ------------------------------------------------------------------ the model
class CoTracker2(nn.Module):
    def __init__(self, cfg: CoTracker2Config = CoTracker2Config()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(cfg.latent_dim, cfg.stride)
        self.updateformer = EfficientUpdateFormer(cfg)
        self.norm = nn.GroupNorm(1, cfg.latent_dim, eps=1e-5)
        self.track_feat_updater = nn.Sequential(nn.Linear(cfg.latent_dim, cfg.latent_dim))
        self.vis_predictor = nn.Sequential(nn.Linear(cfg.latent_dim, 1))

    def window(self, fmaps, coords, feat, vis, exists, iters: int):
        """One window: fmaps [S, C, Hf, Wf], coords [S, N, 2] (feature
        pixels), feat [S, N, C], vis / exists [S, N] -> (coords, vis logits)."""
        c = self.cfg
        s, n = coords.shape[:2]
        hf, wf = fmaps.shape[-2:]
        levels = [fmaps]
        for _ in range(c.corr_levels - 1):
            levels.append(F.avg_pool2d(levels[-1], 2, 2))
        pos = sample_points(pos_embedding_2d(c.input_dim, hf, wf).to(fmaps.device), coords[0])  # [N, E]
        time_emb = sincos_1d(c.input_dim, torch.arange(s)).to(fmaps.device)  # [S, E]
        mask_vis = torch.stack([exists.to(torch.float32), vis], dim=-1)
        for _ in range(iters):
            corrs = []
            for lvl, fm in enumerate(levels):
                h, w = fm.shape[-2:]
                vol = matmul(feat, fm.reshape(s, c.latent_dim, h * w)) / math.sqrt(c.latent_dim)  # [S, N, h·w]
                win = correlation_windows(vol.reshape(s * n, h, w), (coords / 2 ** lvl).reshape(s * n, 2),
                                          c.corr_radius)
                corrs.append(win.reshape(s, n, -1))
            x = torch.cat([flow_embedding(coords - coords[:1], c.flow_emb_dim), *corrs, feat, mask_vis], dim=-1)
            x = x + pos[None] + time_emb[:, None]
            delta = self.updateformer(x.transpose(0, 1), exists).transpose(0, 1)  # [S, N, 2 + C]
            coords = coords + delta[..., :2]
            g = F.group_norm(delta[..., 2:].reshape(s * n, c.latent_dim), 1, self.norm.weight, self.norm.bias, 1e-5)
            feat = feat + F.gelu(linear(self.track_feat_updater[0], g)).reshape(s, n, c.latent_dim)
        return coords, linear(self.vis_predictor[0], feat)[..., 0]

    def forward(self, video: torch.Tensor, queries: torch.Tensor, iters: int | None = None):
        """video [T, H, W, 3] in [0, 255]; queries [N, 3] (t, x, y) pixels ->
        (tracks [T, N, 2] pixels, visibility logits [T, N])."""
        c = self.cfg
        iters = c.iters if iters is None else iters
        t, n = video.shape[0], queries.shape[0]
        s, step = c.window_len, c.window_len // 2
        windows = max(math.ceil((t - s) / step), 0) + 1
        t_pad = (windows - 1) * step + s
        video = torch.cat([video, video[-1:].expand(t_pad - t, -1, -1, -1)])
        fmaps = self.fnet(video.permute(0, 3, 1, 2) / 255.0 * 2.0 - 1.0)  # [Tp, C, Hf, Wf]
        q_frame = queries[:, 0].long()
        q_xy = queries[:, 1:] / c.stride
        feat_q = torch.stack([sample_points(fmaps[int(f)], q_xy[i:i + 1])[0] for i, f in enumerate(q_frame)])
        exists = torch.arange(t_pad, device=video.device)[:, None] >= q_frame[None]
        coords_out = q_xy[None].repeat(t_pad, 1, 1)
        vis_out = torch.zeros(t_pad, n, device=video.device)
        for wi in range(windows):
            a = wi * step
            if wi == 0:
                coords0, vis0 = q_xy[None].repeat(s, 1, 1), torch.full((s, n), 10.0, device=video.device)
            else:
                prev, pv = coords_out[a:a + step], vis_out[a:a + step]
                coords0 = torch.cat([prev, prev[-1:].repeat(s - step, 1, 1)])
                vis0 = torch.cat([pv, pv[-1:].repeat(s - step, 1)])
            ex = exists[a:a + s]
            coords_w, vis_w = self.window(fmaps[a:a + s], coords0, feat_q[None].repeat(s, 1, 1), vis0, ex, iters)
            coords_out[a:a + s] = torch.where(ex[..., None], coords_w, coords_out[a:a + s])
            vis_out[a:a + s] = torch.where(ex, vis_w, vis_out[a:a + s])
        return coords_out[:t] * c.stride, vis_out[:t]


def support_grid(size: int, h: int, w: int) -> torch.Tensor:
    """size x size points (x, y), a margin of w / 64 from every edge."""
    margin = w / 64.0
    gy, gx = torch.meshgrid(torch.linspace(margin, h - margin, size, dtype=torch.float64),
                            torch.linspace(margin, w - margin, size, dtype=torch.float64), indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).to(torch.float32)


@torch.inference_mode()
def predict(model: CoTracker2, video: torch.Tensor, queries: torch.Tensor, support: int = 6):
    """The predictor's semantics for queries on the video's first frame:
    video [T, H, W, 3] in [0, 255], queries [N, 2] (x, y) pixels -> (tracks
    [T, N, 2] pixels, visibility probabilities [T, N], visible [T, N] bool:
    the probability above 0.9, the query frame pinned visible)."""
    c = model.cfg
    t, h, w = video.shape[:3]
    mh, mw = c.model_resolution
    scale = torch.tensor([(mw - 1) / (w - 1), (mh - 1) / (h - 1)], device=video.device)
    q = queries.to(torch.float32) * scale
    q_all = torch.cat([q, support_grid(support, mh, mw).to(video.device)]) if support else q
    q_all = torch.cat([torch.zeros(len(q_all), 1, device=video.device), q_all], dim=1)
    v = F.interpolate(video.to(torch.float32).permute(0, 3, 1, 2), size=(mh, mw), mode="bilinear",
                      align_corners=True).permute(0, 2, 3, 1)
    tracks, logits = model(v, q_all)
    tracks, prob = tracks[:, :len(q)].clone(), torch.sigmoid(logits[:, :len(q)])
    visible = prob > VISIBILITY_THRESHOLD
    tracks[0], visible[0] = q, True
    return tracks / scale, prob, visible
