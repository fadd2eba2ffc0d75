"""Point tracking across video frames: ZNCC template matching, and the
learned CoTracker-style model.

Counterpart of freepose_tpu.models.cotracker.

The correlation mode (the CLI's tracker when no CoTracker2 weights are
given) needs no weights: each point's (2p+1)² image patch on one frame is
matched against (2s+1)² candidate positions on the next, by zero-normalised
cross-correlation, with a quadratic subpixel refinement of the best match;
points are chained frame to frame, forward and backward from the query
frame. The JAX package builds the unit-spaced bilinear tap grids as two
hat-weight matrix products per point (an MXU shape); here each tap reads its
2 x 2 source pixels by index, which is the same bilinear interpolation with
the same zero padding.

The learned mode runs `CoTracker`: a stride-4 CNN encoder per frame, track
features sampled at the query points, and `n_iters` updates in which each
track samples a multi-scale local correlation around its current estimate
and a factorised transformer (attention over time per track, then over
tracks per frame) predicts position deltas and visibility. It follows the
Flax modules' arithmetic: `SAME` convolution padding (asymmetric at stride
2, so padded explicitly), GroupNorm and LayerNorm at eps 1e-6, tanh GELU,
and attention with separate q/k/v/out projections and the query scaled by
1/√Dh, in plain float32 tensor math (the JAX model's attention runs outside
any Pallas kernel). As in the JAX package, `track_device` and
`track_device_batch` (the pipelined and batched smooth paths) are ZNCC in
either mode.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freepose_tpu_torch.ops.sampling import hat_taps

@dataclasses.dataclass(frozen=True)
class CoTrackerConfig:
    feat_dim: int = 128
    stride: int = 4
    corr_levels: int = 4
    corr_radius: int = 3
    hidden_dim: int = 256
    num_heads: int = 8
    time_depth: int = 6
    n_iters: int = 4
    dtype: torch.dtype = torch.float32


COTRACKER_TEST = CoTrackerConfig(
    feat_dim=32, corr_levels=2, corr_radius=2, hidden_dim=64, num_heads=4, time_depth=2, n_iters=2,
)
MAX_FRAMES = 256  # rows of the learned time embedding


def bilinear_sample(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """fmap [H, W, C], coords [..., 2] (x, y) in pixels -> [..., C], zero
    outside the map. With maps [T, H, W, C] and coords [T, ..., 2], each
    frame's coords sample its own map (JAX's vmap over frames) -> [T, ..., C]."""
    h, w = fmap.shape[-3], fmap.shape[-2]
    frame = ()
    if fmap.dim() == 4:
        frame = (torch.arange(fmap.shape[0], device=fmap.device).reshape(-1, *[1] * (coords.dim() - 2)),)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return fmap[frame + (yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long())] * valid[..., None]

    return (tap(y0, x0) * ((1 - wy) * (1 - wx))[..., None] + tap(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
            + tap(y0 + 1, x0) * (wy * (1 - wx))[..., None] + tap(y0 + 1, x0 + 1) * (wy * wx)[..., None])


def _axis_hat_weights(origin: torch.Tensor, n_taps: int, n_src: int) -> torch.Tensor:
    """Bilinear hat weights of a unit-spaced tap row: origin [N] ->
    [N, n_taps, n_src], w[n, k, i] = max(0, 1 - |i - (origin_n + k)|)."""
    src = torch.arange(n_src, dtype=torch.float32, device=origin.device)
    taps = origin[:, None] + torch.arange(n_taps, dtype=torch.float32, device=origin.device)[None]
    return torch.clamp(1.0 - (src[None, None, :] - taps[..., None]).abs(), min=0.0)


def _extract_tap_grids(img: torch.Tensor, origins: torch.Tensor, n_taps: int) -> torch.Tensor:
    """img [H, W, C], origins [N, 2] (x, y) fractional top-left corners ->
    [N, n_taps, n_taps, C] bilinear tap grids at unit spacing (zero past the
    image)."""
    h, w, _ = img.shape
    steps = torch.arange(n_taps, dtype=torch.float32, device=origins.device)
    out = 0.0
    for iy, wy in hat_taps(origins[:, 1:2] + steps, h):
        for ix, wx in hat_taps(origins[:, 0:1] + steps, w):
            out = out + (wy[:, :, None] * wx[:, None, :])[..., None] * img[iy[:, :, None], ix[:, None, :]]
    return out


def _zncc_rows(x: torch.Tensor) -> torch.Tensor:
    x = x - x.mean(dim=-1, keepdim=True)
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-6)


def patch_track_step(img_prev: torch.Tensor, img_next: torch.Tensor, coords: torch.Tensor,
                     patch_radius: int = 4, search: int = 8):
    """One frame-to-frame ZNCC step: img [H, W, 3] float, coords [N, 2]
    pixels on img_prev -> (coords on img_next [N, 2], best score [N]). Ties
    go to the first candidate in (dy, dx) row-major order."""
    p, d = patch_radius, 2 * search + 1
    np_ = 2 * p + 1
    n = coords.shape[0]
    dev = coords.device
    sr = torch.arange(-search, search + 1, dtype=torch.float32, device=dev)
    sy, sx = torch.meshgrid(sr, sr, indexing="ij")
    search_offs = torch.stack([sx.reshape(-1), sy.reshape(-1)], dim=-1)  # [d², 2]

    ref = _zncc_rows(_extract_tap_grids(img_prev, coords - p, np_).reshape(n, -1))
    # A supergrid covering every candidate patch, then its d² windows.
    wsz = 2 * (search + p) + 1
    sg = _extract_tap_grids(img_next, coords - (search + p), wsz)  # [N, S, S, 3]
    iy = (torch.arange(d, device=dev)[:, None] + torch.arange(np_, device=dev)[None]).reshape(-1)
    cand = sg[:, iy].reshape(n, d, np_, wsz, 3)[:, :, :, iy].reshape(n, d, np_, d, np_, 3)
    cand = _zncc_rows(cand.permute(0, 1, 3, 2, 4, 5).reshape(n, d * d, -1))
    corr = torch.einsum("ndp,np->nd", cand, ref)  # [N, d²]

    best = corr.argmax(dim=-1)
    bx, by = best % d, best // d
    c0 = corr.reshape(n, d, d)
    nidx = torch.arange(n, device=dev)

    def subpix(cm, c_, cp):
        denom = cm - 2 * c_ + cp
        return torch.where(denom.abs() > 1e-6, 0.5 * (cm - cp) / denom, 0.0).clamp(-0.5, 0.5)

    centre = c0[nidx, by, bx]
    dx = subpix(c0[nidx, by, (bx - 1).clamp(0, d - 1)], centre, c0[nidx, by, (bx + 1).clamp(0, d - 1)])
    dy = subpix(c0[nidx, (by - 1).clamp(0, d - 1), bx], centre, c0[nidx, (by + 1).clamp(0, d - 1), bx])
    return coords + search_offs[best] + torch.stack([dx, dy], -1), corr[nidx, best]


def _track_chain(frames: torch.Tensor, q: torch.Tensor, patch_radius: int = 4, search: int = 8):
    """ZNCC chained over frames [T, H, W, 3] from frames[0] with queries q
    [N, 2] -> (tracks [T-1, N, 2], scores [T-1, N]) on frames[1:]."""
    coords, tracks, scores = q, [], []
    for t in range(1, frames.shape[0]):
        coords, sc = patch_track_step(frames[t - 1], frames[t], coords, patch_radius, search)
        tracks.append(coords)
        scores.append(sc)
    return torch.stack(tracks), torch.stack(scores)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Flax's `SAME` padding of [B, C, H, W] for a k x k window at `stride`:
    the output is ceil(n / stride) and the padding's odd pixel goes after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes W first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv(nn.Conv2d):
    """nn.Conv2d with Flax's `SAME` padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride[0]))


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, dim: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv(cin, dim, 3, stride)
        self.norm1 = nn.GroupNorm(8, dim, eps=1e-6)
        self.conv2 = SameConv(dim, dim, 3)
        self.norm2 = nn.GroupNorm(8, dim, eps=1e-6)
        self.skip = SameConv(cin, dim, 1, stride) if stride != 1 or cin != dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        h = F.relu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        return F.relu((x if self.skip is None else self.skip(x)) + h)


class BasicEncoder(nn.Module):
    """Per-frame CNN: [T, H, W, 3] -> stride-4 features [T, H/4, W/4, feat_dim]."""

    def __init__(self, cfg: CoTrackerConfig):
        super().__init__()
        f = cfg.feat_dim
        self.stem = SameConv(3, f // 2, 7, 2)
        self.stem_norm = nn.GroupNorm(8, f // 2, eps=1e-6)
        self.res1 = ResidualBlock(f // 2, f // 2, 1)
        self.res2 = ResidualBlock(f // 2, f, 2)
        self.res3 = ResidualBlock(f, f, 1)
        self.out = SameConv(f, f, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_norm(self.stem(images.permute(0, 3, 1, 2))))
        x = self.res3(self.res2(self.res1(x)))
        return self.out(x).permute(0, 2, 3, 1)


def corr_pyramid_features(fmaps: torch.Tensor, track_feats: torch.Tensor, coords: torch.Tensor, levels: int,
                          radius: int) -> torch.Tensor:
    """Multi-scale local correlations: fmaps [T, Hf, Wf, C], track features
    [N, C], coords [T, N, 2] in feature pixels -> [T, N, levels·(2r+1)²];
    each level halves the map (2 x 2 means, an odd row or column dropped)."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    offs = torch.stack(torch.meshgrid(r, r, indexing="xy"), dim=-1).reshape(-1, 2)  # x fastest
    outs, fm = [], fmaps
    for lvl in range(levels):
        patches = bilinear_sample(fm, coords[:, :, None, :] / 2**lvl + offs)  # [T, N, d², C]
        outs.append(torch.einsum("tnpc,nc->tnp", patches, track_feats) / math.sqrt(patches.shape[-1]))
        if lvl + 1 < levels:
            t, h, w, ch = fm.shape
            fm = fm[:, : h // 2 * 2, : w // 2 * 2].reshape(t, h // 2, 2, w // 2, 2, ch).mean((2, 4))
    return torch.cat(outs, dim=-1)


class Attention(nn.Module):
    """Flax's MultiHeadDotProductAttention (self-attention, qkv width = D):
    q/k/v/out projections, the query scaled by 1/√Dh, softmax in float32.
    The Flax kernels [D, H, Dh] / [H, Dh, D] are these Linear weights
    reshaped (models/convert.py:cotracker_from_jax)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, D]
        b, n, d = x.shape
        dh = d // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, dh)

        q = split(self.query(x)) / math.sqrt(dh)
        w = torch.einsum("bqhd,bkhd->bhqk", q, split(self.key(x))).softmax(dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, split(self.value(x))).reshape(b, n, d))


class UpdateBlock(nn.Module):
    """One factorised transformer update on tokens [T, N, D]: attention over
    time per track, then over tracks per frame, then an MLP."""

    def __init__(self, cfg: CoTrackerConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.time_ln = nn.LayerNorm(d, eps=1e-6)
        self.time_attn = Attention(d, cfg.num_heads)
        self.space_ln = nn.LayerNorm(d, eps=1e-6)
        self.space_attn = Attention(d, cfg.num_heads)
        self.mlp_ln = nn.LayerNorm(d, eps=1e-6)
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = tokens.transpose(0, 1)  # [N, T, D]: tracks as the batch
        x = (x + self.time_attn(self.time_ln(x))).transpose(0, 1)
        x = x + self.space_attn(self.space_ln(x))  # frames as the batch
        return x + self.fc2(F.gelu(self.fc1(self.mlp_ln(x)), approximate="tanh"))


class CoTracker(nn.Module):
    """The learned tracker; parameter names follow the JAX tree."""

    def __init__(self, cfg: CoTrackerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = BasicEncoder(cfg)
        corr_dim = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.in_proj = nn.Linear(corr_dim + 2 + 2 * cfg.feat_dim, cfg.hidden_dim)
        self.out_head = nn.Linear(cfg.hidden_dim, 3)  # dx, dy, visibility
        for i in range(cfg.time_depth):
            setattr(self, f"block{i}", UpdateBlock(cfg))
        self.time_embed = nn.Parameter(torch.zeros(MAX_FRAMES, cfg.hidden_dim))

    def forward(self, video: torch.Tensor, queries: torch.Tensor, query_frame: int = 0):
        """video [T, H, W, 3] in [0, 1], queries [N, 2] (x, y) pixels on
        `query_frame` -> (tracks [T, N, 2] pixels, visibility [T, N] in [0, 1])."""
        c = self.cfg
        t = video.shape[0]
        if t > MAX_FRAMES:
            raise ValueError(f"the learned tracker's time embedding holds {MAX_FRAMES} frames, got {t}")
        fmaps = self.encoder(video)
        q0 = queries / c.stride
        q_feat = bilinear_sample(fmaps[query_frame], q0)  # [N, C]
        coords = q0[None].expand(t, -1, -1)
        blocks = [getattr(self, f"block{i}") for i in range(c.time_depth)]
        vis_logits = torch.zeros(coords.shape[:2], device=video.device)
        for _ in range(c.n_iters):
            corr = corr_pyramid_features(fmaps, q_feat, coords, c.corr_levels, c.corr_radius)
            rel = coords - coords[query_frame : query_frame + 1]
            tokens = torch.cat([corr, rel / 16.0, bilinear_sample(fmaps, coords) * 0.1,
                                (q_feat * 0.1)[None].expand(t, -1, -1)], dim=-1)
            x = self.in_proj(tokens) + self.time_embed[:t, None]
            for blk in blocks:
                x = blk(x)
            out = self.out_head(x)
            coords = coords + out[..., :2]
            vis_logits = out[..., 2]
            coords = torch.cat([coords[:query_frame], q0[None], coords[query_frame + 1:]])  # pinned
        visibility = torch.sigmoid(vis_logits)
        visibility[query_frame] = 1.0
        return coords * c.stride, visibility


class PointTracker:
    """Forward and backward tracking of query points from one frame.

    mode="correlation" (ZNCC chaining) needs no weights; mode="learned" runs
    `CoTracker` on `params`, a JAX-layout tree (seeded random ones from
    models/convert.py:random_cotracker_params when None)."""

    def __init__(self, config: CoTrackerConfig = CoTrackerConfig(), params=None, mode: str = "correlation",
                 seed: int = 0, device: str | torch.device | None = None):
        from freepose_tpu_torch.device import resolve_device

        if mode not in ("correlation", "learned"):
            raise ValueError(f"PointTracker mode {mode!r}: 'correlation' or 'learned'")
        self.cfg = config
        self.mode = mode
        self.device = resolve_device(device)
        self.model = None
        if mode == "learned":
            from freepose_tpu_torch.models.convert import cotracker_from_jax, random_cotracker_params

            if params is None:
                params = random_cotracker_params(config, seed)
            self.model = CoTracker(config)
            self.model.load_state_dict(cotracker_from_jax(params))
            self.model.to(self.device).eval()

    def _video(self, video) -> torch.Tensor:
        """uint8 frames move to the device as they are and are normalised there."""
        v = torch.as_tensor(video).to(self.device)
        return v.to(torch.float32) / 255.0 if v.dtype == torch.uint8 else v.to(torch.float32)

    def _queries(self, queries) -> torch.Tensor:
        q = queries if torch.is_tensor(queries) else np.asarray(queries, np.float32)
        return torch.as_tensor(q, dtype=torch.float32).to(self.device)

    def track(self, video, queries, query_frame: int = 0):
        """video [T, H, W, 3] uint8 or float in [0, 1]; queries [N, 2] (x, y)
        pixels on `query_frame` -> (tracks [T, N, 2], visibility [T, N] bool)
        as numpy. Correlation: visible where the ZNCC score exceeds 0.5;
        learned: where the model's visibility does."""
        if self.mode == "learned":
            with torch.inference_mode():
                tracks, vis = self.model(self._video(video), self._queries(queries), query_frame)
            return tracks.cpu().numpy(), (vis > 0.5).cpu().numpy()
        tracks, scores = self.track_device(video, queries, query_frame)
        return tracks.cpu().numpy(), (scores > 0.5).cpu().numpy()

    def track_device(self, video, queries, query_frame: int = 0):
        """ZNCC tracking (in either mode, as in the JAX package) with tensors
        on the device in and out -> (tracks [T, N, 2], scores [T, N])
        float32."""
        v, q = self._video(video), self._queries(queries)
        t = v.shape[0]
        parts_tr, parts_sc = [q[None]], [torch.ones((1, q.shape[0]), dtype=torch.float32, device=q.device)]
        if query_frame < t - 1:
            tr, sc = _track_chain(v[query_frame:], q)
            parts_tr.append(tr)
            parts_sc.append(sc)
        if query_frame > 0:
            tr, sc = _track_chain(v[: query_frame + 1].flip(0), q)
            parts_tr.insert(0, tr.flip(0))
            parts_sc.insert(0, sc.flip(0))
        return torch.cat(parts_tr), torch.cat(parts_sc)

    def track_device_batch(self, videos, queries, device_mesh=None, axis: str = "data"):
        """ZNCC chains for a batch of intervals: videos [I, T, H, W, 3],
        queries [I, N, 2] on frame 0 (the batched smooth path's layout) ->
        (tracks [I, T, N, 2], scores [I, T, N]). The chains are independent,
        so with `device_mesh` the interval axis splits over `axis`: each
        shard runs its own chains on its device, and the results are
        gathered on the mesh's first device."""
        if self.mode == "learned":
            raise ValueError("batched interval tracking is ZNCC-only")
        if device_mesh is None:
            return _track_chain_batch(self._video(videos), self._queries(queries))
        from freepose_tpu_torch.parallel.mesh import gather, split

        videos = torch.as_tensor(videos)
        if videos.shape[0] % device_mesh.shape[axis]:
            raise ValueError(f"interval batch {videos.shape[0]} must divide over the '{axis}' axis "
                             f"({device_mesh.shape[axis]} devices)")
        parts = [
            _track_chain_batch(v.float() / 255.0 if v.dtype == torch.uint8 else v.float(), q)
            for v, q in zip(split(videos, device_mesh, axis), split(self._queries(queries), device_mesh, axis))
        ]
        return gather(parts, device_mesh)


def _track_chain_batch(v: torch.Tensor, q: torch.Tensor):
    """The full-interval chain of each interval in turn, exactly the
    single-interval chain, with the query row (score 1) prepended, as
    track_device with query_frame 0 returns it."""
    tracks, scores = [], []
    for video, queries in zip(v, q):
        tr, sc = _track_chain(video, queries)
        tracks.append(torch.cat([queries[None], tr]))
        scores.append(torch.cat([torch.ones((1, queries.shape[0]), dtype=torch.float32, device=q.device), sc]))
    return torch.stack(tracks), torch.stack(scores)
