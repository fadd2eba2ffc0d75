"""Plain attention for the frozen models: softmax(q·kᵀ·scale)·v, with no
kernel behind it. `mm` and `einsum` are the attention products of every
frozen model; while FP8 is set (reference/control.py) they take float8
(e4m3) operands, each rounded at a per-tensor scale."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
FP8 = False


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 at a per-tensor scale, in x's dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(to_fp8(a), to_fp8(b)) if FP8 else torch.matmul(a, b)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, to_fp8(a), to_fp8(b)) if FP8 else torch.einsum(eq, a, b)


def flash_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, H, N, d], k/v [B, H, Nk, d] -> [B, H, N, d]."""
    return mm(torch.softmax(mm(q, k.transpose(-1, -2)) * scale, dim=-1), v)
