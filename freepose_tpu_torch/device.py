"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card and without an explicit CPU request they raise instead of running
quietly on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> "cuda". A CUDA device without a card raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "freepose_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device cpu) to run on the host"
        )
    return dev
