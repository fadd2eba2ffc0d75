"""CoTracker2's work from the configuration's shapes (the "cotracker2" group of
a configuration file) and the program's counters, in flops.py's terms: a
multiply-add counts 2 operations, only convolutions, matrix products,
attention and the correlation volumes are counted; bytes count each input
read once and each output written once, at float32 (4 bytes), the model's
only dtype.

One predictor call on an interval: the encoder over its padded frames, then
per window `iters` iterations, each the 4-level correlation of every track
with the full feature maps and one pass of the update former over the
window's point and virtual tokens, then the visibility probe. A window's
iteration is affine in its point count, so totals over windows of unequal
point counts follow from their sum (`cotracker2.points`)."""
from __future__ import annotations

from benchmark.flops import attention, attention_bytes, conv, linear

F32 = 4


def _linear(n: int, d_in: int, d_out: int) -> tuple[float, float]:
    """A linear layer on n rows: (operations, bytes of x, W, b and y)."""
    return linear(n, d_in, d_out), float(F32 * (n * d_in + d_in * d_out + d_out + n * d_out))


def _conv(h: int, w: int, h_in: int, w_in: int, c_in: int, c_out: int, k: int) -> tuple[float, float]:
    """A k x k convolution from [c_in, h_in, w_in] to [c_out, h, w]."""
    return conv(h, w, c_in, c_out, k), float(F32 * (c_in * h_in * w_in + c_out * c_in * k * k + c_out + c_out * h * w))


def _attn(batch: int, n_q: int, n_k: int, width: int) -> tuple[float, float]:
    return batch * attention(n_q, n_k, width), batch * attention_bytes(n_q, n_k, width, item=F32)


def _sum(parts) -> tuple[float, float]:
    parts = list(parts)
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def encoder_frame(ct: dict) -> tuple[float, float]:
    """fnet on one frame at the model resolution: the stride-2 stem, the
    four stages of two residual blocks (the first block of a strided stage
    with its 1x1 projection), the 3x3 fusion of the four stages resized to
    stride 4 and the 1x1 output."""
    h, w = ct["model_resolution"]
    d = ct["latent_dim"]
    dims = (d // 2, d // 4 * 3, d, d)
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    parts = [_conv(h2, w2, h, w, 3, d // 2, 7)]
    c_in, hh, ww = d // 2, h2, w2
    for dim, s in zip(dims, (1, 2, 2, 2)):
        ho, wo = (hh + s - 1) // s, (ww + s - 1) // s
        parts += [_conv(ho, wo, hh, ww, c_in, dim, 3), _conv(ho, wo, ho, wo, dim, dim, 3)]
        if s != 1:
            parts.append(_conv(ho, wo, hh, ww, c_in, dim, 1))
        parts += [_conv(ho, wo, ho, wo, dim, dim, 3)] * 2
        c_in, hh, ww = dim, ho, wo
    hf, wf = h // ct["stride"], w // ct["stride"]
    parts += [_conv(hf, wf, hf, wf, sum(dims), 2 * d, 3), _conv(hf, wf, hf, wf, 2 * d, d, 1)]
    return _sum(parts)


def correlation(ct: dict, n: float) -> tuple[float, float]:
    """One iteration's correlation of n tracks over a window: per level the
    full volume [S, N, h, w] (track features · feature map), then the
    (2r+1)² window samples of each track (4 taps each)."""
    s, c = ct["window_len"], ct["latent_dim"]
    h, w = ct["model_resolution"][0] // ct["stride"], ct["model_resolution"][1] // ct["stride"]
    taps = (2 * ct["corr_radius"] + 1) ** 2
    ops, nbytes = 0.0, 0.0
    for _ in range(ct["corr_levels"]):
        ops += 2.0 * s * n * c * h * w
        nbytes += F32 * (s * n * c + s * c * h * w + s * n * h * w)  # features, map, the volume written
        nbytes += F32 * s * n * taps * 5  # four taps read, one sample written
        h, w = h // 2, w // 2
    return ops, nbytes


def update_former(ct: dict, n: float) -> tuple[float, float]:
    """One iteration's update former on n point tracks and the virtual
    tracks over a window of S frames, with the feature update."""
    s, d, v, c = ct["window_len"], ct["hidden_size"], ct["num_virtual_tracks"], ct["latent_dim"]
    d_in = (2 * ct["flow_emb_dim"] + 2) + ct["corr_levels"] * (2 * ct["corr_radius"] + 1) ** 2 + c + 2
    tokens = (n + v) * s

    def block(rows_q: float, rows_kv: float, batch: float, n_q: float, n_k: float):
        """Attention (to_q, to_kv, softmax·v, to_out) and the 4x MLP."""
        return [_linear(rows_q, d, d), _linear(rows_kv, d, 2 * d), _attn(batch, n_q, n_k, d),
                _linear(rows_q, d, d), _linear(rows_q, d, 4 * d), _linear(rows_q, 4 * d, d)]

    parts = [_linear(n * s, d_in, d), _linear(n * s, d, c + 2), _linear(n * s, c, c)]
    for _ in range(ct["depth"]):
        parts += block(tokens, tokens, n + v, s, s)  # time: each token over the window's frames
        parts += block(s * v, s * n, s, v, n)  # virtual <- points, per frame
        parts += block(s * v, s * v, s, v, v)  # virtual self-attention
        parts += block(s * n, s * v, s, n, v)  # points <- virtual
    return _sum(parts)


def work(ct: dict, frames: float, windows: float, iters: float, points: float) -> tuple[float, float]:
    """(operations, bytes) of CoTracker2 from the program's counters:
    `frames` encoded, `windows`, `iters` (over all windows) and `points`
    (summed over the windows)."""
    if windows <= 0:
        return 0.0, 0.0
    n = points / windows
    enc, corr, upd = encoder_frame(ct), correlation(ct, n), update_former(ct, n)
    vis = _linear(ct["window_len"] * n, ct["latent_dim"], 1)
    return (frames * enc[0] + iters * (corr[0] + upd[0]) + windows * vis[0],
            frames * enc[1] + iters * (corr[1] + upd[1]) + windows * vis[1])


def interval(ct: dict, n_points: int, n_frames: int) -> tuple[float, float]:
    """(operations, bytes) of one predictor call on an interval of
    `n_frames` frames and `n_points` tracks (the queries and the support
    grid), all on its first frame."""
    s, step = ct["window_len"], ct["window_len"] // 2
    windows = max(-(-(n_frames - s) // step), 0) + 1
    return work(ct, (windows - 1) * step + s, windows, windows * ct["iters"], windows * n_points)
