"""Whole-K/V attention for the ViTs: CUDA kernel K2 and its plain version.

Counterpart of the whole-K/V regime of freepose_tpu.ops.attention
(`flash_attention` -> `_flash_kernel_single`): softmax(q·kᵀ·scale)·v with
fp32 logits and sums, `p` cast to v's dtype before the P·V product, fp32
accumulation, keys ≥ seq_len masked to -1e30, output acc / max(l, 1e-30).

`flash_attention` is K2's wrapper: a CUDA tensor launches
csrc/flash_attention.cu (or raises), a CPU tensor runs `dense_attention`,
the plain version of the same arithmetic. Every DINOv2 attention call on
the card goes through K2, at every batch size.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of K2. q [B, H, N, d], k/v [B, H, Nk, d] -> [B, H, N, d]
    in q's dtype. Logits, max and sum in fp32 (bf16 products are exact in
    fp32); `p` is rounded to v's dtype before P·V, which accumulates in fp32;
    normalisation comes last, as in the TPU kernel."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K2 wrapper. q [B, H, N, d], k/v [B, H, Nk, d], contiguous, bf16 (or
    fp32 for tests on the card), d = 64. CPU tensors run `dense_attention`."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return dense_attention(q, k, v, scale)
    if not (q.device.type == "cuda" and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: bad shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, n, d = q.shape
    nk = k.shape[2]
    if d != 64:
        raise ValueError(f"flash_attention: head dim {d} is not supported (d = 64 only)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention takes 16-byte aligned q, k, v")
    if n == 0 or nk == 0:
        raise ValueError("flash_attention: empty query or key set")
    from freepose_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n, nk, d,
                    float(scale), _DTYPE_CODES[q.dtype], stream)
    cuda_build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """`attention_fn` for freepose_tpu_torch.models.vit.MultiHeadAttention:
    K2 on the card at every batch size, its plain version on the CPU."""
    return flash_attention(q, k, v, scale)
