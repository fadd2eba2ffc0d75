"""Weight-free point tracking by ZNCC template matching.

Counterpart of the correlation mode of freepose_tpu.models.cotracker (the
CLI's tracker when no CoTracker2 weights are given): each point's (2p+1)²
image patch on one frame is matched against (2s+1)² candidate positions on
the next, by zero-normalised cross-correlation, with a quadratic subpixel
refinement of the best match; points are chained frame to frame, forward
and backward from the query frame. The JAX package builds the unit-spaced
bilinear tap grids as two hat-weight matrix products per point (an MXU
shape); here each tap reads its 2 x 2 source pixels by index, which is the
same bilinear interpolation with the same zero padding.

The learned CoTracker-style model of the JAX module (`mode="learned"`) is
reached by no entry point and is not ported (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from freepose_tpu_torch.ops.sampling import hat_taps


def bilinear_sample(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """fmap [H, W, C], coords [..., 2] (x, y) in pixels -> [..., C], zero
    outside the map."""
    h, w, _ = fmap.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return fmap[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()] * valid[..., None]

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


class PointTracker:
    """Forward and backward ZNCC tracking of query points from one frame.

    Only mode="correlation" is ported; the learned mode raises."""

    def __init__(self, mode: str = "correlation", device: str | torch.device | None = None):
        from freepose_tpu_torch.device import resolve_device

        if mode != "correlation":
            raise NotImplementedError(
                f"PointTracker(mode={mode!r}): the learned CoTracker-style tracker is not ported "
                "(ROADMAP queue 1 item 4); use CoTracker2Predictor")
        self.mode = mode
        self.device = resolve_device(device)

    def track(self, video, queries, query_frame: int = 0):
        """video [T, H, W, 3] uint8 or float in [0, 1]; queries [N, 2] (x, y)
        pixels on `query_frame` -> (tracks [T, N, 2], visibility [T, N] bool)
        as numpy; visible where the ZNCC score exceeds 0.5."""
        tracks, scores = self.track_device(video, queries, query_frame)
        return tracks.cpu().numpy(), (scores > 0.5).cpu().numpy()

    def track_device(self, video, queries, query_frame: int = 0):
        """`track` with tensors on the device in and out: uint8 frames are
        moved as they are and normalised there -> (tracks [T, N, 2], scores
        [T, N]) float32."""
        v = torch.as_tensor(video).to(self.device)
        v = v.to(torch.float32) / 255.0 if v.dtype == torch.uint8 else v.to(torch.float32)
        q = torch.as_tensor(np.asarray(queries, np.float32) if not torch.is_tensor(queries) else queries,
                            dtype=torch.float32).to(self.device)
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
