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

K2, K3 and K4 launch the one tile kernel of csrc/flash_attention.cu, whose
key mask pointer is null for K2 and K3; K5 is a scalar fp32 kernel of the
same library.

Each wrapper launches its kernel for CUDA tensors (or raises on what the
kernel does not take) and runs the plain version for CPU tensors; nothing
falls back quietly. `launches` on each wrapper counts kernel launches.
`flash_attention` picks K2 or K3 as the JAX function picks its regime, and
`flash_attention_auto` routes a masked call to K4 and an unmasked one to
`flash_attention`, as in the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 72, 256)  # the bf16 head dims the kernels are built for
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


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


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            kv_mask: torch.Tensor | None, dtypes) -> torch.Tensor:
    """Launch csrc/flash_attention.cu's entry point: the tile kernel for bf16
    (kv_mask None runs it unmasked), the scalar kernel for fp32."""
    from freepose_tpu_torch.ops import cuda_build

    _check_qkv(name, q, k, v, dtypes)
    b, h, n, d = q.shape
    nk = k.shape[2]
    kv_mask = _mask_bytes(name, kv_mask, b, nk, q.device)
    mask_ptr = None if kv_mask is None else kv_mask.data_ptr()
    fn = cuda_build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), b * h, h, n, nk, d,
                    float(scale), _DTYPE_CODES[q.dtype], stream)
    cuda_build.check(status, name)
    return out


def flash_attention_k2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K2 wrapper. q [B, H, N, d], k/v [B, H, Nk, d], contiguous; bf16 with
    d in {64, 72, 256}, or fp32 with d = 64 (tests on the card). CPU tensors
    run `dense_attention`."""
    if _on_cpu(q, k, v):
        return dense_attention(q, k, v, scale)
    out = _launch("flash_attention_k2", q, k, v, scale, None, _DTYPE_CODES)
    d = q.shape[3]
    flash_attention_k2.launches += 1
    flash_attention_k2.launches_by_dim[d] = flash_attention_k2.launches_by_dim.get(d, 0) + 1
    return out


flash_attention_k2.launches = 0
flash_attention_k2.launches_by_dim = {}  # the same launches, by head dim


def flash_attention_k3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K3 wrapper: the streaming regime, bf16, d in {64, 72, 256}. On the
    card it is K2's launch (one device program serves both TPU regimes),
    counted apart so that the regime `flash_attention` picked stays
    visible. CPU tensors run `dense_attention`."""
    if _on_cpu(q, k, v):
        return dense_attention(q, k, v, scale)
    out = _launch("flash_attention_k3", q, k, v, scale, None, (torch.bfloat16,))
    flash_attention_k3.launches += 1
    return out


flash_attention_k3.launches = 0


def flash_attention_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """K4 wrapper. q [B, H, N, d], k/v [B, H, Nk, d] bf16 with d in {64, 72,
    256}; kv_mask [B, Nk] bool (False = masked key), shared by the heads.
    CPU tensors run `dense_attention_masked`."""
    if _on_cpu(q, k, v):
        return dense_attention_masked(q, k, v, scale, kv_mask)
    out = _launch("flash_attention_stream", q, k, v, scale, kv_mask, (torch.bfloat16,))
    flash_attention_stream.launches += 1
    return out


flash_attention_stream.launches = 0


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
    both regimes are the same launch of one tile kernel, so the TPU's VMEM
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
                         interpret: bool = False) -> torch.Tensor:
    """K5 wrapper. q [B, H, N, 64], k/v [B, H, Nk, 64] fp32 contiguous; bias
    [H, N, Nk] fp32 contiguous, shared across the batch; kv_mask [B, Nk]
    bool (False = masked key). CPU tensors run `dense_attention_bias`.
    block_q, block_k and interpret are TPU tiling knobs and change nothing
    here."""
    from freepose_tpu_torch.ops import cuda_build

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
    fn = cuda_build.load("flash_attention").flash_attention_bias_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(), b * h, h, n, nk, d,
                    float(scale), stream)
    cuda_build.check(status, name)
    flash_attention_bias.launches += 1
    return out


flash_attention_bias.launches = 0


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
