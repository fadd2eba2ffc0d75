"""CoTracker2, the released point tracker (facebookresearch/co-tracker), as
nn.Modules.

Counterpart of freepose_tpu.models.cotracker2. Module and parameter names
are those of the released `cotracker2` checkpoint (fnet.*, updateformer.*
with its `virual_tracks` spelling, norm, track_feat_updater.0,
vis_predictor.0), so its state dict loads as it is; models/convert.py:
cotracker2_from_jax carries over the JAX package's parameter tree.

  - BasicEncoder `fnet`: a stride-2 stem and 4 residual stages with
    instance norms (no affine parameters), every stage resized to stride 4
    (bilinear, align_corners) and fused by a 3x3 and a 1x1 convolution.
  - Each iteration correlates the track features with a 4-level average-pool
    pyramid of the feature maps (full [S, N, H, W] volumes) and samples a
    (2r+1)² unit-spaced window around each track, border padded.
  - EfficientUpdateFormer: tokens [N + 64 virtual, S, 384]; 6 blocks of
    attention over time, each followed by a space step (virtual <- point
    cross-attention, virtual self-attention, point <- virtual
    cross-attention). Masked logits are replaced by -1e30, so a row with
    every key masked attends uniformly.
  - Sliding windows of 8 frames, step 4: a window after the first starts its
    first 4 frames from the previous window's predictions and repeats the
    last of them for the rest.
  - CoTracker2Predictor: resize to the model resolution, a support grid on
    frame 0, a backward pass where a query sits after frame 0, visibility
    above 0.9, query frames pinned.

Everything runs in float32; the caller keeps TF32 off (scripts/common.py:
full_fp32) for the products to be the fp32 ones. Bilinear samples read their
2 x 2 source pixels by index, the same interpolation as the JAX package's
hat-weight matrix products.

On a card, under inference (no autograd), a window's iteration replays two
CUDA graphs captured the second time its shape comes (_WindowGraphs): the
correlation and the update, the eager path's kernels in its order, so the
host launches two graphs an iteration where it launched some hundreds of
kernels. A window shape's first window runs eagerly.

Tracing (utils/timing.py): spans `cotracker2.encoder` (fnet over the padded
video) and `cotracker2.window` (one sliding window) over `cotracker2.corr`
(the pyramid correlation and its windows) and `cotracker2.update` (the
update former and the feature update), one of each per iteration; the
predictor's upload of its queries and fetch of its results are
`wait.cotracker2.queries` and `wait.cotracker2.result`. Counters:
`cotracker2.frames` (frames encoded), `cotracker2.windows`,
`cotracker2.iters` (iterations over all windows) and `cotracker2.points`
(points tracked, summed over the windows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freepose_tpu_torch.ops.sampling import hat_taps, resize_bilinear_ac
from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import GraphCache, capture

VISIBILITY_THRESHOLD = 0.9  # the predictor's: a point is visible where sigmoid(logit) exceeds it


@dataclasses.dataclass(frozen=True)
class CoTracker2Config:
    latent_dim: int = 128          # fnet output / track-feature dim
    stride: int = 4
    window_len: int = 8
    corr_levels: int = 4
    corr_radius: int = 3
    flow_emb_dim: int = 64         # flow embedding: 2 * 64 + 2 dims
    hidden_size: int = 384
    num_heads: int = 8
    depth: int = 6                 # time blocks; a space step follows each
    num_virtual_tracks: int = 64
    model_resolution: tuple = (384, 512)
    iters: int = 6                 # the predictor's default

    @property
    def input_dim(self) -> int:
        """Token dim: flow embedding + correlation windows + feature +
        mask/visibility. 456 for the released model."""
        d = 2 * self.corr_radius + 1
        return (2 * self.flow_emb_dim + 2) + self.corr_levels * d * d + self.latent_dim + 2


COTRACKER2 = CoTracker2Config()
# The JAX package's test config: the same topology at small widths.
COTRACKER2_TEST = CoTracker2Config(
    latent_dim=16, corr_levels=4, corr_radius=1, flow_emb_dim=16, hidden_size=64, num_heads=4, depth=2,
    num_virtual_tracks=4, model_resolution=(64, 96), iters=2,
)


# ---------------------------------------------------------------------------
# sin/cos embeddings
# ---------------------------------------------------------------------------

def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim]: cat(sin(pos·w), cos(pos·w))."""
    omega = 1.0 / 10000 ** (np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def time_embedding(embed_dim: int, window_len: int) -> np.ndarray:
    """[window_len, embed_dim]."""
    return _sincos_1d(embed_dim, np.arange(window_len, dtype=np.float64))


def pos_embedding_2d(embed_dim: int, grid_hw: tuple) -> np.ndarray:
    """[H, W, embed_dim]: the first half embeds x, the second y."""
    h, w = grid_hw
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    emb = np.concatenate([_sincos_1d(embed_dim // 2, gx), _sincos_1d(embed_dim // 2, gy)], axis=1)
    return emb.reshape(h, w, embed_dim)


def flow_embedding(xy: torch.Tensor, dim: int = 64) -> torch.Tensor:
    """[..., 2] -> [..., 2·dim + 2]: xy, then interleaved sin/cos of x and
    of y at frequencies k·1000/dim."""
    freqs = torch.arange(0, dim, 2, dtype=torch.float32, device=xy.device) * (1000.0 / dim)
    x, y = xy[..., 0:1] * freqs, xy[..., 1:2] * freqs
    pe_x = torch.stack([torch.sin(x), torch.cos(x)], dim=-1).reshape(*xy.shape[:-1], dim)
    pe_y = torch.stack([torch.sin(y), torch.cos(y)], dim=-1).reshape(*xy.shape[:-1], dim)
    return torch.cat([xy, pe_x, pe_y], dim=-1)


# ---------------------------------------------------------------------------
# Bilinear sampling by index
# ---------------------------------------------------------------------------

def sample_features_nd(fmap: torch.Tensor, coords: torch.Tensor, border: bool = False) -> torch.Tensor:
    """fmap [H, W, C], coords [N, 2] (x, y) -> [N, C] bilinear samples."""
    h, w, _ = fmap.shape
    out = 0.0
    for iy, wy in hat_taps(coords[:, 1], h, border):
        for ix, wx in hat_taps(coords[:, 0], w, border):
            out = out + (wy * wx)[:, None] * fmap[iy, ix]
    return out


def sample_windows(vol: torch.Tensor, centers: torch.Tensor, radius: int, border: bool = True) -> torch.Tensor:
    """vol [N, H, W], centers [N, 2] (x, y) -> [N, (2r+1)²] unit-spaced
    window samples, the x offset varying slowest (the released
    CorrBlock.sample order)."""
    n, h, w = vol.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=vol.device)
    rows = torch.arange(n, device=vol.device)[:, None, None]
    out = 0.0
    for iy, wy in hat_taps(centers[:, 1:2] + offs[None], h, border):  # [N, d]
        for ix, wx in hat_taps(centers[:, 0:1] + offs[None], w, border):
            out = out + wx[:, :, None] * wy[:, None, :] * vol[rows, iy[:, None, :], ix[:, :, None]]
    return out.reshape(n, -1)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters over NCHW (biased variance)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _ln_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] 2 x 2 average pool, stride 2 (floor)."""
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    return x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


# ---------------------------------------------------------------------------
# BasicEncoder (fnet)
# ---------------------------------------------------------------------------

class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride)) if stride != 1 else None

    def forward(self, x):
        y = F.relu(_instance_norm(self.conv1(x)))
        y = F.relu(_instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = _instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """[T, 3, H, W] -> [T, latent_dim, H/stride, W/stride]."""

    def __init__(self, output_dim: int = 128, stride: int = 4):
        super().__init__()
        self.stride = stride
        d = output_dim
        self.conv1 = nn.Conv2d(3, d // 2, 7, stride=2, padding=3)
        dims = (d // 2, d // 4 * 3, d, d)
        in_planes = d // 2
        for i, (dim, s) in enumerate(zip(dims, (1, 2, 2, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(ResidualBlock(in_planes, dim, s), ResidualBlock(dim, dim)))
            in_planes = dim
        self.conv2 = nn.Conv2d(sum(dims), d * 2, 3, padding=1)
        self.conv3 = nn.Conv2d(d * 2, d, 1)

    def forward(self, x):
        out_hw = (x.shape[2] // self.stride, x.shape[3] // self.stride)
        x = F.relu(_instance_norm(self.conv1(x)))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(resize_bilinear_ac(x, out_hw))
        x = F.relu(_instance_norm(self.conv2(torch.cat(feats, dim=1))))
        return self.conv3(x)


# ---------------------------------------------------------------------------
# EfficientUpdateFormer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """to_q / fused to_kv / to_out. attn_mask: bool, broadcastable to the
    logits [..., heads, q, k]; True = masked out, its logit replaced by
    -1e30 (a row with every key masked attends uniformly)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_kv = nn.Linear(dim, dim * 2)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, context=None, attn_mask=None):
        ctx = x if context is None else context
        h = self.heads
        hd = x.shape[-1] // h
        q = self.to_q(x).unflatten(-1, (h, hd))
        k, v = (t.unflatten(-1, (h, hd)) for t in self.to_kv(ctx).chunk(2, dim=-1))
        sim = torch.einsum("...qhd,...khd->...hqk", q, k) * (hd ** -0.5)
        if attn_mask is not None:
            sim = sim.masked_fill(attn_mask, -1e30)
        out = torch.einsum("...hqk,...khd->...qhd", sim.softmax(dim=-1), v)
        return self.to_out(out.flatten(-2))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class AttnBlock(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.attn = Attention(hidden, heads)
        self.mlp = Mlp(hidden, hidden * 4)

    def forward(self, x):
        x = x + self.attn(_ln_noaffine(x))
        return x + self.mlp(_ln_noaffine(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.norm_context = nn.LayerNorm(hidden, eps=1e-5)
        self.cross_attn = Attention(hidden, heads)
        self.mlp = Mlp(hidden, hidden * 4)

    def forward(self, x, context, attn_mask=None):
        x = x + self.cross_attn(_ln_noaffine(x), context=self.norm_context(context), attn_mask=attn_mask)
        return x + self.mlp(_ln_noaffine(x))


class EfficientUpdateFormer(nn.Module):
    def __init__(self, cfg: CoTracker2Config):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        self.num_virtual_tracks = cfg.num_virtual_tracks
        self.input_transform = nn.Linear(cfg.input_dim, d)
        self.flow_head = nn.Linear(d, cfg.latent_dim + 2)
        self.virual_tracks = nn.Parameter(torch.zeros(1, cfg.num_virtual_tracks, 1, d))  # the released spelling
        self.time_blocks = nn.ModuleList(AttnBlock(d, h) for _ in range(cfg.depth))
        self.space_virtual_blocks = nn.ModuleList(AttnBlock(d, h) for _ in range(cfg.depth))
        self.space_point2virtual_blocks = nn.ModuleList(CrossAttnBlock(d, h) for _ in range(cfg.depth))
        self.space_virtual2point_blocks = nn.ModuleList(CrossAttnBlock(d, h) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x [N, T, input_dim], mask [T, N] bool (True = the point exists)
        -> [N, T, latent_dim + 2] (dx, dy, feature delta)."""
        v = self.num_virtual_tracks
        tokens = self.input_transform(x)
        tokens = torch.cat([tokens, self.virual_tracks[0].expand(-1, tokens.shape[1], -1)], dim=0)
        mask_ctx = mask_q = None
        if mask is not None:
            masked = ~mask  # [T, N]
            mask_ctx = masked[:, None, None, :]  # a virtual query ignores absent points
            mask_q = masked[:, None, :, None]  # an absent point's row attends uniformly
        for time, v2p, virt, p2v in zip(self.time_blocks, self.space_virtual2point_blocks,
                                        self.space_virtual_blocks, self.space_point2virtual_blocks):
            tokens = time(tokens)  # over T, per token
            pts, vir = tokens[:-v].transpose(0, 1), tokens[-v:].transpose(0, 1)  # [T, n, D], per frame
            vir = virt(v2p(vir, pts, attn_mask=mask_ctx))
            pts = p2v(pts, vir, attn_mask=mask_q)
            tokens = torch.cat([pts, vir], dim=1).transpose(0, 1)
        return self.flow_head(tokens[:-v])


# ---------------------------------------------------------------------------
# A window's iteration as CUDA graphs
# ---------------------------------------------------------------------------

class _WindowGraphs:
    """One window shape's iteration as two CUDA graphs over static buffers:
    `corr` reads the pyramid, the track features and the coordinates into
    `out`; `update` reads those and `out` and writes the new coordinates and
    features back into their buffers. An iteration is one replay of each,
    where the eager path launches some hundreds of kernels. `load` fills the
    buffers with a window's tensors."""

    def __init__(self, model, pyr, coords, track_feat, track_mask_vis, sampled_pos, time_emb, track_mask):
        self.pyr = [p.clone() for p in pyr]
        self.coords, self.track_feat = coords.clone(), track_feat.clone()
        self.track_mask_vis, self.sampled_pos = track_mask_vis.clone(), sampled_pos.clone()
        self.track_mask = track_mask.clone()

        def warm_up():  # an iteration that writes no buffer
            model._update(self.coords, model._corr(self.pyr, self.track_feat, self.coords), self.track_feat,
                          self.track_mask_vis, self.sampled_pos, time_emb, self.track_mask)

        def corr():
            self.out = model._corr(self.pyr, self.track_feat, self.coords)

        def update():
            coords, feat = model._update(self.coords, self.out, self.track_feat, self.track_mask_vis,
                                         self.sampled_pos, time_emb, self.track_mask)
            self.coords.copy_(coords)
            self.track_feat.copy_(feat)

        self.corr, self.update = capture(coords.device, warm_up, corr, update)

    def load(self, pyr, coords, track_feat, track_mask_vis, sampled_pos, track_mask) -> None:
        for dst, src in zip(self.pyr + [self.coords, self.track_feat, self.track_mask_vis, self.sampled_pos,
                                        self.track_mask],
                            list(pyr) + [coords, track_feat, track_mask_vis, sampled_pos, track_mask]):
            dst.copy_(src)


# ---------------------------------------------------------------------------
# Core model
# ---------------------------------------------------------------------------

class CoTracker2(nn.Module):
    """The online model: sliding windows of `window_len`, step half of it."""

    def __init__(self, cfg: CoTracker2Config = COTRACKER2):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(cfg.latent_dim, cfg.stride)
        self.updateformer = EfficientUpdateFormer(cfg)
        self.norm = nn.GroupNorm(1, cfg.latent_dim, eps=1e-5)
        self.track_feat_updater = nn.Sequential(nn.Linear(cfg.latent_dim, cfg.latent_dim))
        self.vis_predictor = nn.Sequential(nn.Linear(cfg.latent_dim, 1))
        self._embeddings: dict = {}
        self._graphs = GraphCache()

    def _embedding(self, name: str, shape: tuple, device) -> torch.Tensor:
        """The sin/cos position (grid `shape`) or time (window `shape`)
        embedding on `device`, made once per shape."""
        key = (name, shape, str(device))
        if key not in self._embeddings:
            fn = pos_embedding_2d if name == "pos" else time_embedding
            self._embeddings[key] = torch.as_tensor(fn(self.cfg.input_dim, *shape), device=device)
        return self._embeddings[key]

    def _corr(self, pyr, track_feat, coords):
        """One iteration's correlation: the track features against each
        pyramid level, a (2r+1)² window sampled around each track -> [S, N,
        levels·(2r+1)²]."""
        c = self.cfg
        s, n = coords.shape[:2]
        corr_scale = float(np.sqrt(np.float32(c.latent_dim)))
        corrs = []
        for lvl, fm in enumerate(pyr):
            vol = torch.einsum("snc,schw->snhw", track_feat, fm) / corr_scale
            win = sample_windows(vol.flatten(0, 1), (coords / 2.0 ** lvl).flatten(0, 1), c.corr_radius)
            corrs.append(win.reshape(s, n, -1))
        return torch.cat(corrs, dim=-1)

    def _update(self, coords, corr, track_feat, track_mask_vis, sampled_pos, time_emb, track_mask):
        """One iteration's update former and feature update -> (coords,
        track_feat)."""
        c = self.cfg
        s, n = coords.shape[:2]
        tin = torch.cat([flow_embedding(coords - coords[0:1], c.flow_emb_dim), corr, track_feat, track_mask_vis],
                        dim=-1)
        x = (tin + sampled_pos[None] + time_emb[:, None]).transpose(0, 1)  # [N, S, E]
        delta = self.updateformer(x, mask=track_mask).transpose(0, 1)  # [S, N, 2 + C]
        upd = self.track_feat_updater(self.norm(delta[..., 2:].reshape(s * n, c.latent_dim)))
        # exact GELU (nn.GELU())
        return coords + delta[..., :2], track_feat + F.gelu(upd).reshape(s, n, c.latent_dim)

    def _window_graphs(self, pyr, coords, track_feat, track_mask_vis, sampled_pos, time_emb, track_mask):
        """The CUDA graphs of a window's iteration at this shape, or None
        (eager): on a card, without autograd, made the second time a shape
        comes (a shape seen once runs eagerly; utils/cuda_graphs.py)."""
        if coords.device.type != "cuda" or torch.is_grad_enabled():
            return None
        key = (tuple(pyr[0].shape), tuple(coords.shape), str(coords.device), torch.is_inference_mode_enabled())
        graphs = self._graphs.get(key, lambda: _WindowGraphs(self, pyr, coords, track_feat, track_mask_vis,
                                                               sampled_pos, time_emb, track_mask))
        if graphs is not None:
            graphs.load(pyr, coords, track_feat, track_mask_vis, sampled_pos, track_mask)
        return graphs

    def forward_window(self, fmaps, coords, track_feat, vis, track_mask, iters):
        """fmaps [S, C, Hf, Wf]; coords [S, N, 2] (feature px); track_feat
        [S, N, C]; vis / track_mask [S, N] -> (coords, track_feat,
        vis_logits [S, N]). On a card each iteration replays the window
        shape's two CUDA graphs (_WindowGraphs), the same operations as the
        eager path, launched at once."""
        c = self.cfg
        hf, wf = fmaps.shape[-2:]
        s = coords.shape[0]
        dev = fmaps.device
        pyr = [fmaps]
        for _ in range(c.corr_levels - 1):
            pyr.append(_avg_pool2(pyr[-1]))
        track_mask_vis = torch.stack([track_mask.to(torch.float32), vis], dim=-1)
        sampled_pos = sample_features_nd(self._embedding("pos", ((hf, wf),), dev), coords[0])  # [N, E]
        time_emb = self._embedding("time", (s,), dev)
        graphs = self._window_graphs(pyr, coords, track_feat, track_mask_vis, sampled_pos, time_emb, track_mask)
        timing.count("cotracker2.iters", iters)
        for _ in range(iters):
            with timing.span("cotracker2.corr"):
                if graphs is None:
                    corr = self._corr(pyr, track_feat, coords)
                else:
                    graphs.corr.replay()
            with timing.span("cotracker2.update"):
                if graphs is None:
                    coords, track_feat = self._update(coords, corr, track_feat, track_mask_vis, sampled_pos,
                                                      time_emb, track_mask)
                else:
                    graphs.update.replay()
        if graphs is not None:
            coords, track_feat = graphs.coords.clone(), graphs.track_feat.clone()
        return coords, track_feat, self.vis_predictor(track_feat)[..., 0]

    def forward(self, video: torch.Tensor, queries: torch.Tensor, iters: int | None = None):
        """video [T, H, W, 3] float in [0, 255]; queries [N, 3] (t, x, y)
        pixels -> (tracks [T, N, 2] pixels, vis_logits [T, N])."""
        c = self.cfg
        iters = c.iters if iters is None else iters
        t_total, n = video.shape[0], queries.shape[0]
        s, step = c.window_len, c.window_len // 2
        num_windows = max((t_total - s + step - 1) // step, 0) + 1
        t_pad = (num_windows - 1) * step + s
        if t_pad > t_total:
            video = torch.cat([video, video[-1:].expand(t_pad - t_total, -1, -1, -1)])
        with timing.span("cotracker2.encoder"):
            fmaps = self.fnet((2.0 * (video / 255.0) - 1.0).permute(0, 3, 1, 2))  # [Tp, C, Hf, Wf]
        timing.count("cotracker2.frames", t_pad)

        q_frame = queries[:, 0].to(torch.int64)
        q_coords = queries[:, 1:] / c.stride
        fm_hwc = fmaps.permute(0, 2, 3, 1)
        # The query frame's feature at each query point (zero padding).
        track_feat_q = 0.0
        for iy, wy in hat_taps(q_coords[:, 1], fm_hwc.shape[1], False):
            for ix, wx in hat_taps(q_coords[:, 0], fm_hwc.shape[2], False):
                track_feat_q = track_feat_q + (wy * wx)[:, None] * fm_hwc[q_frame, iy, ix]

        exists = torch.arange(t_pad, device=video.device)[:, None] >= q_frame[None]  # [Tp, N]
        coords_out = q_coords[None].repeat(t_pad, 1, 1)
        vis_out = torch.zeros((t_pad, n), dtype=torch.float32, device=video.device)
        for wi in range(num_windows):
            ind = wi * step
            if wi == 0:
                coords_init = q_coords[None].repeat(s, 1, 1)
                vis_init = torch.full((s, n), 10.0, device=video.device)
            else:
                prev, pv = coords_out[ind:ind + step], vis_out[ind:ind + step]
                coords_init = torch.cat([prev, prev[-1:].expand(s - step, -1, -1)])
                vis_init = torch.cat([pv, pv[-1:].expand(s - step, -1)])
            track_mask = exists[ind:ind + s]
            timing.count("cotracker2.windows")
            timing.count("cotracker2.points", n)
            with timing.span("cotracker2.window"):
                coords_w, _, vis_w = self.forward_window(fmaps[ind:ind + s], coords_init,
                                                         track_feat_q[None].expand(s, -1, -1), vis_init, track_mask,
                                                         iters)
                # Points whose query frame comes later stay at their query.
                coords_out[ind:ind + s] = torch.where(track_mask[..., None], coords_w, coords_out[ind:ind + s])
                vis_out[ind:ind + s] = torch.where(track_mask, vis_w, vis_out[ind:ind + s])
        return coords_out[:t_total] * c.stride, vis_out[:t_total]


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

def support_grid(size: int, extent_hw: tuple) -> np.ndarray:
    """size x size points with a margin of width / 64 -> [size², 2] (x, y)."""
    h, w = extent_hw
    margin = w / 64.0
    gy, gx = np.meshgrid(np.linspace(margin, h - margin, size), np.linspace(margin, w - margin, size),
                         indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1).astype(np.float32)


class CoTracker2Predictor:
    """The released CoTrackerPredictor's semantics: resize the video to the
    model resolution (bilinear, align_corners), append a support grid on
    frame 0, run forward (and backward on the reversed video, merged into the
    frames before each query's frame), threshold visibility at
    VISIBILITY_THRESHOLD (0.9), pin the
    query frames, rescale the tracks to the input resolution.

    params: the JAX package's CoTracker2 parameter tree (a --tracker-weights
    .npz), carried over by models/convert.py:cotracker2_from_jax;
    `from_state_dict` takes a state dict in the released key layout. Runs on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, params, config: CoTracker2Config = COTRACKER2, support_grid_size: int = 6,
                 device: str | torch.device | None = None):
        from freepose_tpu_torch.models.convert import cotracker2_from_jax

        self._load(cotracker2_from_jax(params), config, support_grid_size, device)

    @classmethod
    def from_state_dict(cls, state_dict, config: CoTracker2Config = COTRACKER2, support_grid_size: int = 6,
                        device: str | torch.device | None = None) -> "CoTracker2Predictor":
        """A predictor of a state dict in the released key layout
        (cotracker2.pth's), loaded as it is."""
        pred = cls.__new__(cls)
        pred._load(state_dict, config, support_grid_size, device)
        return pred

    def _load(self, state_dict, config: CoTracker2Config, support_grid_size: int, device) -> None:
        from freepose_tpu_torch.device import resolve_device

        self.cfg = config
        self.device = resolve_device(device)
        model = CoTracker2(config)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.support_grid_size = support_grid_size

    @torch.inference_mode()
    def _run(self, video: torch.Tensor, queries: np.ndarray):
        v = resize_bilinear_ac(video.permute(0, 3, 1, 2), self.cfg.model_resolution).permute(0, 2, 3, 1)
        with timing.wait("cotracker2.queries"):  # an upload from pageable memory synchronises
            q = torch.as_tensor(queries, device=self.device)
        tracks, vis_logits = self.model(v.contiguous(), q, self.cfg.iters)
        return tracks, torch.sigmoid(vis_logits)

    def __call__(self, video, queries: np.ndarray, backward_tracking: bool = True):
        """video [T, H, W, 3] in [0, 255] (uint8 or float, numpy or a
        tensor); queries [N, 3] (t, x, y) pixels -> (tracks [T, N, 2],
        visibility [T, N] bool) as numpy."""
        cfg = self.cfg
        t, h, w = video.shape[:3]
        mh, mw = cfg.model_resolution
        v = torch.as_tensor(video).to(self.device, torch.float32)
        q = np.asarray(queries, np.float32).copy()
        q[:, 1] *= (mw - 1) / (w - 1)
        q[:, 2] *= (mh - 1) / (h - 1)
        sg = support_grid(self.support_grid_size, (mh, mw))
        q_all = np.concatenate([q, np.concatenate([np.zeros((len(sg), 1), np.float32), sg], axis=1)])
        tracks, vis = self._run(v, q_all)
        # The backward pass fills only frames before a query's frame: with
        # every query on frame 0 it would change nothing.
        if backward_tracking and float(q_all[:, 0].max()) > 0:
            inv_q = q_all.copy()
            inv_q[:, 0] = t - 1 - inv_q[:, 0]
            inv_tracks, inv_vis = self._run(v.flip(0), inv_q)
            with timing.wait("cotracker2.queries"):
                q_frames = torch.as_tensor(q_all[:, 0], device=self.device)
            before = torch.arange(t, device=self.device)[:, None] < q_frames[None]
            tracks = torch.where(before[..., None], inv_tracks.flip(0), tracks)
            vis = torch.where(before, inv_vis.flip(0), vis)
        with timing.wait("cotracker2.result"):
            tracks = tracks[:, :len(q)].cpu().numpy()
            vis = (vis[:, :len(q)] > VISIBILITY_THRESHOLD).cpu().numpy()
        qt = np.asarray(queries)[:, 0].astype(int)
        ar = np.arange(len(qt))
        tracks[qt, ar] = q[:, 1:]
        vis[qt, ar] = True
        tracks *= np.array([(w - 1) / (mw - 1), (h - 1) / (mh - 1)], np.float32)
        return tracks, vis

    def track(self, video, queries: np.ndarray, query_frame: int = 0):
        """PointTracker.track's interface: video uint8, or float in [0, 1]
        (numpy or a tensor on the device); queries [N, 2] (x, y) on
        `query_frame`; tracked both ways."""
        v = torch.as_tensor(video).to(self.device)
        v = v.to(torch.float32) if v.dtype == torch.uint8 else v.to(torch.float32) * 255.0
        q = np.concatenate([np.full((len(queries), 1), float(query_frame), np.float32),
                            np.asarray(queries, np.float32)], axis=1)
        return self(v, q, backward_tracking=True)
