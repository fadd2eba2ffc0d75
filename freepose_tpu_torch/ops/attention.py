"""Attention on the card: CUDA kernels K2 to K5 and their plain versions.

Counterpart of freepose_tpu.ops.attention. Every kernel computes
softmax(q·kᵀ·scale)·v with operands in their dtype (bf16 for K2 to K4, fp32
for K5), fp32 logits, max, sum and accumulator, `p` cast to v's dtype
before the P·V product, and the output acc / max(l, 1e-30):

- K2 `flash_attention_k2`, the whole-K/V regime (`_flash_kernel_single` on
  the TPU): DINOv2 (d = 64), the Hiera-L global blocks (d = 72) and SAM2
  memory self-attention (d = 256).
- K3 `flash_attention_k3`, the streaming regime of `flash_attention`
  (`_flash_kernel`): on the card the same launch as K2.
- K4 `flash_attention_stream`, streaming attention with a per-batch key
  mask shared by the heads (`_stream_kernel`): SAM2 memory cross-attention
  over ~28.7k keys with empty slots masked.

- K5 `flash_attention_bias` (`_stream_bias_kernel`): fp32 attention with an
  additive per-head logit bias [H, N, Nk] shared across the batch, and an
  optional key mask: the relative-position bias of the BEiT trunk of ZoeD_N.

`_launch` picks the device program of each call (`attention_kernel`):
every bf16 call, K2, K3 and K4 at d 64, 72 and 256, runs the wgmma + TMA
kernel of csrc/flash_attention_sm90.cu (with its combine kernel when it
splits the keys, `sm90_config`; a masked call first lists the key tiles
that hold a valid key, `key_tiles`, and skips the others); fp32 K2 runs the
scalar kernel of csrc/flash_attention.cu. K5 is a register-tiled fp32
kernel of the same library (32-row blocks, key splits merged by the combine
kernel: `k5_config`).

Each wrapper launches its kernel for CUDA tensors (or raises on what the
kernel does not take) and runs the plain version for CPU tensors; nothing
falls back quietly. Each launch is counted while tracing is on
(utils/timing.py): `launch.<kernel>` per wrapper (`launch.k2.d<dim>` by head
dim too), and `launch.sm90` or `launch.f32` by the device program `_launch`
ran.
`flash_attention` picks K2 or K3 as the JAX function picks its regime, and
`flash_attention_auto` routes a masked call to K4 and an unmasked one to
`flash_attention`, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import heapq

import torch

from freepose_tpu_torch.ops import cuda_build
from freepose_tpu_torch.utils import timing

NEG_INF = -1e30
HEAD_DIMS = (64, 72, 256)  # the bf16 head dims the kernels are built for
_DTYPES = (torch.bfloat16, torch.float32)
MAX_SPLITS, MIN_SPLIT_TILES = 16, 8
# Device time of a wave of the sm90 kernel's blocks of w consumer warpgroups
# (64·w query rows; w = 1 runs two blocks per SM, more one), over that of a
# wave of the largest, by head dim (chip_smoke.py's k2 and k2_d72 phases,
# H100 80GB HBM3 at 700 W). d 64: 1.332 ms in 117 waves of 64-row blocks
# against 1.232 ms in 78 of 192-row ones at [128, 16, 905, 64]; with it the
# wave counts predict both builds' times at 1, 2, 4, 8 and 128 crops of 905
# tokens within 10%. d 72: 0.1809, 0.1053 and 0.1272 ms for 64-, 128- and
# 192-row blocks at [1, 8, 4096, 72], 2 waves each.
WAVE_COST = {64: {1: 0.72, 3: 1.0}, 72: {1: 1.42, 2: 0.83, 3: 1.0}, 256: {2: 1.0}}


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of K2 and K3. q [B, H, N, d], k/v [B, H, Nk, d] ->
    [B, H, N, d] in q's dtype. Logits, max and sum in fp32 (bf16 products are
    exact in fp32); `p` is rounded to v's dtype before P·V, which accumulates
    in fp32; normalisation comes last, as in the TPU kernels."""
    return dense_attention_masked(q, k, v, scale)


def dense_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K4: `dense_attention` with an optional per-batch key
    mask kv_mask [B, Nk] (False = masked key, logit -1e30). A row whose keys
    are all masked averages V uniformly, as the TPU kernel does."""
    return dense_attention_bias(q, k, v, scale, None, kv_mask)


def dense_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         bias: torch.Tensor | None, kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K5: fp32 logits q·kᵀ·scale, plus bias[h] (bias
    [H, N, Nk], shared across the batch, added in fp32), then the key mask
    at -1e30, then the softmax of `dense_attention_masked`."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    if kv_mask is not None:
        logits = torch.where(kv_mask.to(torch.bool)[:, None, None, :], logits,
                             torch.full((), NEG_INF, device=logits.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def bf16_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, ref: torch.Tensor,
                     kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for bf16 attention, given
    the plain version's output `ref`. Both round each p to bf16 (relative
    error <= 2^-8, against different maxima), so their P·V sums differ by at
    most 2^-7·Σ p|v| / l; both round the output to bf16, which adds at most
    2^-7·|ref|. The checks of K2, K3 and K4 on the card hold them to it."""
    mass = dense_attention_masked(q, k, v.abs(), scale, kv_mask).float()
    return 2.0 ** -7 * (mass + ref.float().abs())


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtypes) -> None:
    """Raise on what the kernels do not take: another device, dtype or head
    dim, mismatched shapes, non-contiguous or misaligned storage."""
    if not (q.device.type == "cuda" and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes q/k/v of one dtype in {[str(t) for t in dtypes]}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    d = q.shape[3]
    if d not in (HEAD_DIMS if q.dtype == torch.bfloat16 else (64,)):
        raise ValueError(f"{name}: head dim {d} is not supported for {q.dtype} "
                         f"(bf16: {HEAD_DIMS}; fp32: 64)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} takes 16-byte aligned q, k, v")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"{name}: empty query or key set")


def _mask_bytes(name: str, kv_mask: torch.Tensor | None, b: int, nk: int,
                device: torch.device) -> torch.Tensor | None:
    """kv_mask [B, Nk] on the kernel's device -> contiguous uint8 (0 =
    masked key), the kernels' layout; raises on another shape or device."""
    if kv_mask is None:
        return None
    if kv_mask.device != device or tuple(kv_mask.shape) != (b, nk):
        raise ValueError(f"{name}: kv_mask must be [{b}, {nk}] on {device}, got "
                         f"{tuple(kv_mask.shape)} on {kv_mask.device}")
    return kv_mask.to(torch.uint8).contiguous()


def attention_kernel(dtype: torch.dtype, d: int, masked: bool) -> str:
    """The dispatch rule of `_launch`: the device program that serves a
    call. "sm90" (csrc/flash_attention_sm90.cu, wgmma + TMA) for every bf16
    call, at d 64, 72 and 256, with or without a key mask; "f32" (the scalar
    kernel of csrc/flash_attention.cu) for fp32."""
    return "f32" if dtype == torch.float32 else "sm90"


@functools.lru_cache(maxsize=4096)
def sm90_config(bh: int, n: int, nk: int, d: int, key_tile: int, num_sms: int = 132,
                masked: bool = False) -> tuple[int, int]:
    """(consumer warpgroups, key splits) of the sm90 kernel for q [bh, n, d]
    against nk keys in tiles of `key_tile` (`sm90_key_tile`); a warpgroup
    owns 64 query rows. The warpgroups whose waves of blocks cost least
    (`WAVE_COST`), the fewest on ties. A grid short of a wave splits the
    keys into the count (at most MAX_SPLITS, at least MIN_SPLIT_TILES key
    tiles each, none empty) whose grid fills its waves best, the fewest on
    ties. A masked call takes twice that count (within the same limits):
    the kernel shares each batch element's listed tiles among its splits,
    and the host, which knows only nk, cannot see how unevenly the mask
    spreads them; at K4's shape 1, 2, 3, 4, 6 and 8 splits took 0.683,
    0.359, 0.254, 0.257, 0.272 and 0.290 ms (chip_smoke.py's k4 phase, H100
    80GB HBM3 at 700 W)."""
    def waves(w):
        return -(-(bh * -(-n // (64 * w))) // (num_sms * (2 if w == 1 else 1)))

    wgs = min(sorted(WAVE_COST[d]), key=lambda w: waves(w) * WAVE_COST[d][w])
    wave = num_sms * (2 if wgs == 1 else 1)
    blocks = bh * -(-n // (64 * wgs))
    tiles = -(-nk // key_tile)
    most = min(MAX_SPLITS, tiles // MIN_SPLIT_TILES)
    best, best_fill = 1, 0.0
    if blocks < wave:
        for s in range(1, most + 1):
            per = -(-tiles // s)
            if -(-tiles // per) != s:  # a split would be empty
                continue
            grid = blocks * s
            fill = grid / (-(-grid // wave) * wave)
            if fill > best_fill:
                best, best_fill = s, fill
    if masked and best > 1:
        best = max(s for s in range(best, min(2 * best, most) + 1) if -(-tiles // -(-tiles // s)) == s)
    return wgs, best


K5_KEY_TILE = 64  # keys per streamed tile of K5 (csrc/flash_attention.cu:K5_BK)
K5_ROWS = 32  # query rows per block of K5 (csrc/flash_attention.cu:K5_BQ); two blocks per SM
K5_MAX_SPLITS = 4
# K5's cost model, fitted to its device times at 1-4 key splits at the
# ZoeD_N shape [1, 16, 577, 64] (chip_smoke.py's k5 phase, H100 80GB HBM3 at
# 700 W: 0.0881, 0.0755, 0.0726 and 0.0713 ms; the model within 7% of each).
# Units: a query row against a key tile in a block that shares its SM with
# one other. Every block pays K5_BLOCK_COST units of set-up (Q and the first
# stage), and a split call K5_COMBINE_COST units per split for the combine.
K5_BLOCK_COST = 16
K5_COMBINE_COST = 27


@functools.lru_cache(maxsize=1024)
def k5_config(bh: int, n: int, nk: int, num_sms: int = 132) -> int:
    """Key splits of K5 for q [bh, n, 64] against nk keys: the least
    modelled device time. The model deals the grid's blocks, in launch
    order (x = bh fastest, then row tiles, then splits), to the earliest
    free of 2·num_sms slots, each block costing K5_ROWS · its split's key
    tiles + K5_BLOCK_COST; the time is the last slot's, plus the combine.
    Ties go to fewer splits. Split counts that would leave a split empty
    are not taken."""
    tiles = -(-nk // K5_KEY_TILE)
    best, best_cost = 1, None
    for s in range(1, min(K5_MAX_SPLITS, tiles) + 1):
        per = -(-tiles // s)
        if -(-tiles // per) != s:
            continue
        slots = [0] * (2 * num_sms)
        for z in range(s):
            work = K5_ROWS * min(per, tiles - z * per) + K5_BLOCK_COST
            for _ in range(bh * -(-n // K5_ROWS)):
                heapq.heapreplace(slots, slots[0] + work)
        cost = max(slots) + (K5_COMBINE_COST * s if s > 1 else 0)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def key_tile_list(kv_mask: torch.Tensor, key_tile: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the list kernel (`key_tiles`): for kv_mask [B, Nk]
    (False = masked key) and tiles of `key_tile` keys, per batch element the
    count of tiles that hold a valid key [B] (int32), their indices in
    increasing order [B, T] (int32, -1 past the count) and a flag on each
    listed tile that also holds a masked key [B, T] (uint8, 0 past the
    count); T = ceil(Nk / key_tile), and keys past Nk are not masked keys.
    An element with no valid key lists every tile, each flagged: its rows
    average V over its Nk keys. Torch operations on the mask's device,
    nothing read on the host."""
    b, nk = kv_mask.shape
    tiles = -(-nk // key_tile)
    keys = torch.arange(tiles * key_tile, device=kv_mask.device).reshape(tiles, key_tile) < nk
    valid = torch.zeros((b, tiles * key_tile), dtype=torch.bool, device=kv_mask.device)
    valid[:, :nk] = kv_mask.to(torch.bool)
    n_valid = valid.reshape(b, tiles, key_tile).sum(-1)
    listed = n_valid > 0
    none = ~listed.any(-1, keepdim=True)
    listed = listed | none
    partial = (n_valid < keys.sum(-1)) & listed
    order = torch.sort((~listed).to(torch.uint8), dim=-1, stable=True).indices  # listed tiles first, in order
    count = listed.sum(-1)
    held = torch.arange(tiles, device=kv_mask.device) < count[:, None]
    tile_list = torch.where(held, order, -1).to(torch.int32)
    flags = torch.where(held, partial.gather(-1, order), False).to(torch.uint8)
    return count.to(torch.int32), tile_list, flags


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                       kv_mask: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain (m, l, acc) of one key range, as a key split of the sm90 kernel
    leaves them: m the row max of q·kᵀ·scale, l the row sum of
    p = exp(q·kᵀ·scale - m), acc = p (rounded to v's dtype)·v; all fp32.
    q [..., N, d], k/v [..., Nk, d] -> [..., N], [..., N], [..., N, d].
    kv_mask [B, Nk] as for K4 (q [B, H, N, d]): a masked key's logit is
    -1e30. An empty key range gives m = -1e30, l = 0, acc = 0, what an empty
    share of a masked call's key tiles leaves. bias [H, N, Nk] (the key
    range's columns), added before the mask, gives what a key split of K5
    leaves."""
    if k.shape[-2] == 0:
        return (torch.full(q.shape[:-1], NEG_INF, device=q.device), q.new_zeros(q.shape[:-1], dtype=torch.float32),
                q.new_zeros(q.shape[:-1] + v.shape[-1:], dtype=torch.float32))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    if kv_mask is not None:
        logits = torch.where(kv_mask.to(torch.bool)[:, None, None, :], logits,
                             torch.full((), NEG_INF, device=logits.device))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(dim=-1), torch.matmul(p.to(v.dtype).float(), v.float())


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of the combine kernel: merge the partials of S key
    splits, m and l [S, ...] and acc [S, ..., d] fp32, into
    Σ e^(m_s - M)·acc_s / max(Σ e^(m_s - M)·l_s, 1e-30), M = max m_s, in
    `dtype`."""
    w = torch.exp(m - m.amax(dim=0))
    total = (w * l).sum(dim=0)
    return ((w[..., None] * acc).sum(dim=0) / torch.clamp(total, min=1e-30)[..., None]).to(dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # the C entry points of the attention libraries
    ("flash_attention_sm90", "flash_sm90_launch"): [_P] * 11 + [_I] * 7 + [_F, _P],
    ("flash_attention_sm90", "flash_sm90_key_tiles_launch"): [_P, _I, _I, _I, _P, _P, _P, _P],
    ("flash_attention_sm90", "flash_sm90_combine_launch"): [_P] * 4 + [_I] * 3 + [_P],
    ("flash_attention_sm90", "flash_sm90_key_tile"): [_I],
    ("flash_attention", "flash_f32_launch"): [_P] * 4 + [_I] * 4 + [_F, _P],
    ("flash_attention", "flash_attention_bias_launch"): [_P] * 9 + [_I] * 6 + [_F, _P],
    ("flash_attention", "flash_bias_combine_launch"): [_P] * 4 + [_I, ctypes.c_long, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(lib: str, fn: str):
    """A kernel library's C entry point (built at first use), its argument
    types set once; each returns an int (a cudaError_t for the launches)."""
    entry = getattr(cuda_build.load(lib), fn)
    entry.argtypes = _ARGTYPES[lib, fn]
    entry.restype = ctypes.c_int
    return entry


@functools.lru_cache(maxsize=None)
def sm90_key_tile(d: int) -> int:
    """Keys per tile of the sm90 kernel at head dim d, as the library
    states it (`Sm90::BK`, read once per head dim)."""
    tile = _entry("flash_attention_sm90", "flash_sm90_key_tile")(d)
    if tile <= 0:
        raise ValueError(f"the sm90 kernel does not take head dim {d} (it takes {HEAD_DIMS})")
    return tile


def attention_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Combine wrapper: m and l [S, B, H, N], acc [S, B, H, N, d], fp32 and
    contiguous -> [B, H, N, d]. CUDA tensors launch the combine kernel of
    csrc/split_combine.cuh as built into the sm90 library (bf16 output),
    CPU tensors run `combine_partials`."""
    name = "attention_combine"
    if _on_cpu(m, l, acc):
        return combine_partials(m, l, acc, dtype)
    if dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise TypeError(f"{name} takes fp32 partials to a bf16 output, got {m.dtype}, {l.dtype}, {acc.dtype} "
                        f"-> {dtype}")
    if not (m.device.type == "cuda" and l.device == m.device and acc.device == m.device):
        raise ValueError(f"{name}: partials on {m.device}, {l.device}, {acc.device}")
    if m.shape != l.shape or acc.shape[:-1] != m.shape or acc.shape[-1] % 4:
        raise ValueError(f"{name}: bad shapes {tuple(m.shape)}, {tuple(l.shape)}, {tuple(acc.shape)}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (m, l, acc)):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned partials")
    out = torch.empty(acc.shape[1:], dtype=dtype, device=acc.device)
    d = acc.shape[-1]
    with torch.cuda.device(acc.device):
        status = _entry("flash_attention_sm90", "flash_sm90_combine_launch")(
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), acc.shape[0], out.numel() // d, d,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(status, name)
    timing.count("launch.attention_combine")
    return out


def key_tiles(kv_mask: torch.Tensor, key_tile: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """List wrapper: kv_mask [B, Nk] -> the (count, tile list, partial
    flags) of `key_tile_list`. A CUDA mask launches sm90_key_tiles_kernel
    (which a masked call of the sm90 kernel also launches, inside its own C
    call), a CPU mask runs `key_tile_list`."""
    name = "key_tiles"
    if kv_mask.device.type == "cpu":
        return key_tile_list(kv_mask, key_tile)
    if kv_mask.device.type != "cuda" or kv_mask.ndim != 2 or 0 in kv_mask.shape or key_tile < 1:
        raise ValueError(f"{name}: kv_mask [B, Nk] on a CUDA device, got {tuple(kv_mask.shape)} on "
                         f"{kv_mask.device}, key tile {key_tile}")
    b, nk = kv_mask.shape
    tiles = -(-nk // key_tile)
    mask = kv_mask.to(torch.uint8).contiguous()
    count = torch.empty(b, dtype=torch.int32, device=mask.device)
    tile_list = torch.empty((b, tiles), dtype=torch.int32, device=mask.device)
    flags = torch.empty((b, tiles), dtype=torch.uint8, device=mask.device)
    with torch.cuda.device(mask.device):
        status = _entry("flash_attention_sm90", "flash_sm90_key_tiles_launch")(
            mask.data_ptr(), b, nk, key_tile, count.data_ptr(), tile_list.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(status, name)
    timing.count("launch.key_tiles")
    return count, tile_list, flags


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_sm90(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                 mask: torch.Tensor | None, stream: int, config: tuple[int, int] | None) -> torch.Tensor:
    """csrc/flash_attention_sm90.cu at `config` (warpgroups, splits), by
    default the `sm90_config` of the call. With key splits the same C call
    launches the kernel into one fp32 scratch tensor (acc, then m, then l)
    and the combine kernel from it; with a mask (uint8 [B, Nk]) it first
    launches the list kernel into one int32 buffer (count, tile list, then
    the partial flags as bytes)."""
    b, h, n, d = q.shape
    nk = k.shape[2]
    key_tile = sm90_key_tile(d)
    wgs, splits = config or sm90_config(b * h, n, nk, d, key_tile, _num_sms(q.device), mask is not None)
    out = torch.empty_like(q)
    parts = (None, None, None)
    if splits > 1:
        rows = splits * b * h * n
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
        parts = (scratch.data_ptr(), scratch.data_ptr() + 4 * rows * d, scratch.data_ptr() + 4 * rows * (d + 1))
    lists = (None, None, None)
    if mask is not None:
        tiles = -(-nk // key_tile)
        buf = torch.empty(b * (1 + tiles) + -(-b * tiles // 4), dtype=torch.int32, device=q.device)
        lists = (buf.data_ptr(), buf.data_ptr() + 4 * b, buf.data_ptr() + 4 * b * (1 + tiles))
    status = _entry("flash_attention_sm90", "flash_sm90_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *parts, None if mask is None else mask.data_ptr(),
        *lists, b * h, h, n, nk, d, wgs, splits, float(scale), stream)
    cuda_build.check(status, name)
    if mask is not None:
        timing.count("launch.key_tiles")
    if splits > 1:
        timing.count("launch.attention_combine")
    return out


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            kv_mask: torch.Tensor | None, dtypes, kernel: str | None = None,
            config: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch the device program `attention_kernel` picks for the call (or
    `kernel`): the sm90 kernel (at `config`, see `_launch_sm90`), or
    csrc/flash_attention.cu's scalar fp32 kernel (unmasked). Counts the
    launch as `launch.<kernel>`."""
    _check_qkv(name, q, k, v, dtypes)
    b, h, n, d = q.shape
    nk = k.shape[2]
    kernel = kernel or attention_kernel(q.dtype, d, kv_mask is not None)
    kv_mask = _mask_bytes(name, kv_mask, b, nk, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "sm90":
            out = _launch_sm90(name, q, k, v, scale, kv_mask, stream, config)
        else:
            out = torch.empty_like(q)
            cuda_build.check(_entry("flash_attention", "flash_f32_launch")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n, nk, d, float(scale), stream),
                name)
    timing.count("launch." + kernel)
    return out


def flash_attention_k2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K2 wrapper. q [B, H, N, d], k/v [B, H, Nk, d], contiguous; bf16 with
    d in {64, 72, 256}, or fp32 with d = 64 (tests on the card). CPU tensors
    run `dense_attention`."""
    if _on_cpu(q, k, v):
        return dense_attention(q, k, v, scale)
    out = _launch("flash_attention_k2", q, k, v, scale, None, _DTYPES)
    timing.count("launch.k2")
    timing.count(f"launch.k2.d{q.shape[3]}")
    return out


def flash_attention_k3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K3 wrapper: the streaming regime, bf16, d in {64, 72, 256}. On the
    card it is K2's launch (one device program per head dim serves both TPU
    regimes), counted apart so that the regime `flash_attention` picked
    stays visible. CPU tensors run `dense_attention`."""
    if _on_cpu(q, k, v):
        return dense_attention(q, k, v, scale)
    out = _launch("flash_attention_k3", q, k, v, scale, None, (torch.bfloat16,))
    timing.count("launch.k3")
    return out


def flash_attention_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """K4 wrapper. q [B, H, N, d], k/v [B, H, Nk, d] bf16 with d in {64, 72,
    256}; kv_mask [B, Nk] bool (False = masked key), shared by the heads.
    CPU tensors run `dense_attention_masked`."""
    if _on_cpu(q, k, v):
        return dense_attention_masked(q, k, v, scale, kv_mask)
    out = _launch("flash_attention_stream", q, k, v, scale, kv_mask, (torch.bfloat16,))
    timing.count("launch.k4")
    return out


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         config: tuple[int, int], kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The sm90 kernel at `config` (warpgroups, key splits) whatever
    `sm90_config` picks, bf16 at d 64 (1 or 3 warpgroups), 72 (1, 2 or 3)
    or 256 (2), kv_mask as for K4 (a masked call's splits may outnumber its
    listed tiles): chip_smoke.py checks and times each configuration at the
    main paths' shapes with it. CPU tensors run `dense_attention_masked`."""
    if _on_cpu(q, k, v):
        return dense_attention_masked(q, k, v, scale, kv_mask)
    return _launch("flash_attention_sm90", q, k, v, scale, kv_mask, (torch.bfloat16,), kernel="sm90",
                   config=config)


def _round16(x: int) -> int:
    return max(16, -(-x // 16) * 16)


def whole_kv_fits(q: torch.Tensor, k: torch.Tensor, single_budget: int) -> bool:
    """The JAX function's regime rule (freepose_tpu/ops/attention.py:142-149):
    the whole-K/V regime when K, V and a 16-row fp32 score tile fit the
    budget."""
    nk16 = _round16(k.shape[2])
    kv_bytes = 2 * nk16 * q.shape[3] * q.element_size()
    return max(0, (single_budget - kv_bytes) // (4 * nk16)) // 16 * 16 >= 16


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, block_q: int = 1024,
                    block_k: int = 512, interpret: bool = False,
                    single_budget: int | None = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v through K2 or K3, with the JAX signature.

    single_budget None (the default) takes K2 for every shape: on the H100
    both regimes are the same launch of one kernel, so the TPU's VMEM
    budget has nothing to choose. An integer budget applies the
    JAX rule, so `single_budget=0` selects K3. block_q, block_k and
    interpret are TPU tiling knobs and change nothing here."""
    if single_budget is None or whole_kv_fits(q, k, single_budget):
        return flash_attention_k2(q, k, v, scale)
    return flash_attention_k3(q, k, v, scale)


def flash_attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX package's routing: a key mask goes to K4, no mask to
    `flash_attention` (K2). The JAX function also sends unmasked calls whose
    K/V exceed its 6 MB VMEM budget to the streaming kernel; K2 streams K/V
    through shared memory at any length, so here every unmasked call takes
    `flash_attention`. Plain versions on the CPU."""
    if kv_mask is not None:
        return flash_attention_stream(q, k, v, scale, kv_mask=kv_mask)
    return flash_attention(q, k, v, scale)


def flash_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, bias: torch.Tensor,
                         kv_mask: torch.Tensor | None = None, block_q: int = 256, block_k: int = 512,
                         interpret: bool = False, splits: int | None = None) -> torch.Tensor:
    """K5 wrapper. q [B, H, N, 64], k/v [B, H, Nk, 64] fp32 contiguous; bias
    [H, N, Nk] fp32 contiguous, shared across the batch; kv_mask [B, Nk]
    bool (False = masked key). CPU tensors run `dense_attention_bias`.
    `splits` forces a key-split count (chip_smoke.py times each); by default
    `k5_config` picks. With key splits the same C call launches the kernel
    into one fp32 scratch tensor (acc, then m, then l) and the combine
    kernel from it. block_q, block_k and interpret are TPU tiling knobs and
    change nothing here."""
    name = "flash_attention_bias"
    if _on_cpu(q, k, v, bias):
        return dense_attention_bias(q, k, v, scale, bias, kv_mask)
    _check_qkv(name, q, k, v, (torch.float32,))
    b, h, n, d = q.shape
    nk = k.shape[2]
    if bias.device != q.device or bias.dtype != torch.float32 or tuple(bias.shape) != (h, n, nk):
        raise ValueError(f"{name}: bias must be fp32 [{h}, {n}, {nk}] on {q.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if not bias.is_contiguous() or bias.data_ptr() % 16:
        raise ValueError(f"{name} takes a contiguous, 16-byte aligned bias")
    kv_mask = _mask_bytes(name, kv_mask, b, nk, q.device)
    splits = splits or k5_config(b * h, n, nk, _num_sms(q.device))
    out = torch.empty_like(q)
    parts = (None, None, None)
    if splits > 1:
        total = splits * b * h * n
        scratch = torch.empty(total * (d + 2), dtype=torch.float32, device=q.device)
        parts = (scratch.data_ptr(), scratch.data_ptr() + 4 * total * d, scratch.data_ptr() + 4 * total * (d + 1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry("flash_attention", "flash_attention_bias_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None if kv_mask is None else kv_mask.data_ptr(),
            out.data_ptr(), *parts, b * h, h, n, nk, d, splits, float(scale), stream)
    cuda_build.check(status, name)
    timing.count("launch.k5")
    if splits > 1:
        timing.count("launch.bias_combine")
    return out


def bias_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """K5's combine wrapper: m and l [S, B, H, N], acc [S, B, H, N, 64], fp32
    and contiguous -> [B, H, N, 64] fp32. CUDA tensors launch the combine
    kernel of csrc/split_combine.cuh as built into K5's library (which a K5
    call with key splits also launches, inside its own C call), CPU tensors
    run `combine_partials` in fp32."""
    name = "bias_combine"
    if _on_cpu(m, l, acc):
        return combine_partials(m, l, acc, torch.float32)
    if any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise TypeError(f"{name} takes fp32 partials, got {m.dtype}, {l.dtype}, {acc.dtype}")
    if not (m.device.type == "cuda" and l.device == m.device and acc.device == m.device):
        raise ValueError(f"{name}: partials on {m.device}, {l.device}, {acc.device}")
    if m.shape != l.shape or acc.shape[:-1] != m.shape or acc.shape[-1] != 64:
        raise ValueError(f"{name}: bad shapes {tuple(m.shape)}, {tuple(l.shape)}, {tuple(acc.shape)}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (m, l, acc)):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned partials")
    out = torch.empty(acc.shape[1:], dtype=torch.float32, device=acc.device)
    with torch.cuda.device(acc.device):
        status = _entry("flash_attention", "flash_bias_combine_launch")(
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), acc.shape[0], out.numel() // 64,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(status, name)
    timing.count("launch.bias_combine")
    return out


def flash_attention_bias_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                              bias: torch.Tensor) -> torch.Tensor:
    """Biased attention of the BEiT blocks: K5 on the card, its plain
    version on the CPU. The JAX function runs the Pallas kernel on the TPU
    and dense XLA elsewhere."""
    return flash_attention_bias(q, k, v, scale, bias)


def flash_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """`attention_fn` for freepose_tpu_torch.models.vit.MultiHeadAttention:
    K2 on the card at every batch size, its plain version on the CPU."""
    return flash_attention_k2(q, k, v, scale)
