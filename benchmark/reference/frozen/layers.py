"""Flax-style layers for the port's models: NHWC data, the JAX package's dtypes.

Each layer casts its input to its own dtype first, as a Flax layer with
`dtype=` set computes in that dtype. Weights are in torch's layouts (Linear
[out, in], Conv OIHW, ConvTranspose [in, out, kh, kw]); the converters of
models/convert.py map the JAX trees onto them. Module and parameter names
follow the JAX tree, so that mapping is by name.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(n_in, n_out, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """flax.linen.LayerNorm: epsilon 1e-6 unless given."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """flax.linen.GroupNorm on [B, H, W, C]: epsilon 1e-6 unless given."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__(groups, dim, eps=eps, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps).permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """flax.linen.Conv on [B, H, W, C]. padding is the symmetric pad per
    side (Flax's "SAME" for the stride = kernel and 1x1 convs used here is 0)."""

    def __init__(self, n_in: int, n_out: int, kernel: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(n_in, n_out, kernel, stride=stride, padding=padding, groups=groups, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax.linen.ConvTranspose with kernel = stride (no overlap) on
    [B, H, W, C]. Flax applies its kernel unflipped: the converter flips it
    into torch's layout."""

    def __init__(self, n_in: int, n_out: int, kernel: int, dtype: torch.dtype = torch.float32):
        super().__init__(n_in, n_out, kernel, stride=kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax.linen.gelu(approximate=False): the exact erf GELU."""
    return F.gelu(x)
