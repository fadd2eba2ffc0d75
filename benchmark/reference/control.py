"""The control: the reference computed at float8 (e4m3), the precision
below the configuration's bfloat16. Within `fp8_products()` every matrix
product and convolution of the frozen models (F.linear, F.conv2d,
F.conv_transpose2d) and every attention product (frozen/attention.py: q·kᵀ
and p·v) takes float8-rounded operands, each scaled per tensor to e4m3's
range; the products accumulate in float32, as a float8 kernel's do."""
from __future__ import annotations

import contextlib

import torch.nn.functional as F

from benchmark.reference.frozen import attention
from benchmark.reference.frozen.attention import to_fp8


@contextlib.contextmanager
def fp8_products():
    linear, conv2d, conv_t = F.linear, F.conv2d, F.conv_transpose2d

    def q_linear(x, w, b=None):
        return linear(to_fp8(x), to_fp8(w), b)

    def q_conv2d(x, w, b=None, *args, **kwargs):
        return conv2d(to_fp8(x), to_fp8(w), b, *args, **kwargs)

    def q_conv_t(x, w, b=None, *args, **kwargs):
        return conv_t(to_fp8(x), to_fp8(w), b, *args, **kwargs)

    F.linear, F.conv2d, F.conv_transpose2d = q_linear, q_conv2d, q_conv_t
    attention.FP8 = True
    try:
        yield
    finally:
        F.linear, F.conv2d, F.conv_transpose2d = linear, conv2d, conv_t
        attention.FP8 = False
