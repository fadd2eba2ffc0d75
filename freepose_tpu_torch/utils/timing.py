"""Per-stage wall-clock timing, device-synchronizing.

Counterpart of freepose_tpu.utils.timing.StageTimer. PyTorch returns from a
CUDA call before the card finishes, so each stage synchronizes CUDA at entry
and exit (when a card is present) and the totals are real stage times; they
flow into the BOP CSV `time` column.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self, sync: bool = True):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.sync:
            _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def total(self) -> float:
        return sum(self.totals.values())

    def report(self) -> str:
        lines = [
            f"{name:<28s} {self.totals[name]:8.3f}s total  {self.mean(name) * 1000:8.2f} ms/call  x{self.counts[name]}"
            for name in sorted(self.totals, key=lambda n: -self.totals[n])
        ]
        return "\n".join(lines)
