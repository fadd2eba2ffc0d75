"""Peaks of one NVIDIA H100 (SXM, dense, at its 700 W limit; NVIDIA's data
sheet), the least time a piece of work could take on it, and the device
time of kernel groups read from a profiler trace."""
from __future__ import annotations

import re

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# Kernel groups by the symbol the profiler records: the port's bf16
# attention program takes its head dim as its first template argument.
KERNEL_GROUPS = {
    "k2_d64": re.compile(r"sm90_attention_kernel<64,"),
    "sam2_attention": re.compile(r"sm90_attention_kernel<(72|256),|split_combine_kernel<__nv_bfloat16>|"
                                 r"sm90_key_tiles_kernel"),
}


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least seconds for `flops` operations at `peak_flops` and `nbytes`
    moved at the card's peak bandwidth: the larger of the two."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def group_device_s(kernels: list[tuple[str, float]], group: str) -> float:
    """Seconds of device time of the kernels [(symbol, seconds)] in `group`."""
    pattern = KERNEL_GROUPS[group]
    return sum(s for name, s in kernels if pattern.search(name))


def share(bound: float, measured: float) -> float | None:
    """The roofline share in %, None where nothing was measured."""
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured
