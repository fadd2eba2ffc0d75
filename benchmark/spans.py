"""Spans the benchmark records around its calls into each layer, and the
reduction of a profiler trace of the card to busy time, launches, kernel
time by symbol and idle gaps.

Spans are kept only in a traced run (`--trace 1`), where each one
synchronises the card at both ends so that a layer's span holds its device
work; an untraced run records nothing and synchronises nothing."""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.device = device
        self.records: list[tuple[str, float, float]] = []  # (name, start, end) on the host's clock
        self.counts: dict[str, float] = defaultdict(float)
        self._start_cache: list[float] = []

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.records.append((name, t0, time.perf_counter()))

    def count(self, name: str, n: float = 1.0) -> None:
        if self.enabled:
            self.counts[name] += n

    def total_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.records if n == name)

    def at(self, t: float) -> str:
        """The span open at host time t (spans follow one another), or
        "host"."""
        i = bisect.bisect_right(self._starts(), t) - 1
        return self.records[i][0] if i >= 0 and self.records[i][2] >= t else "host"

    def _starts(self) -> list[float]:
        if len(self._start_cache) != len(self.records):
            self._start_cache = [s for _, s, _ in self.records]
        return self._start_cache


def device_events(prof) -> list[tuple[str, float, float]]:
    """(symbol, start s, end s) of every operation the profiler saw on the
    card, on the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() * 1e-9 if hasattr(e, "start_ns") else e.start_us() * 1e-6
        dur = e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") else e.duration_us() * 1e-6
        if dur > 0:
            out.append((e.name(), start, start + dur))
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_intervals(events: list[tuple[str, float, float]]) -> list[tuple[float, float]]:
    """The union of the events' intervals, sorted."""
    merged: list[list[float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events: list[tuple[str, float, float]], window: tuple[float, float], spans: Spans,
              offset: float, top: int = 10) -> dict:
    """Busy seconds, kernel launches, kernel seconds by symbol, the `top`
    device operations and the `top` idle gaps, each gap named by the span
    the host was in when it began. `window` is the traced window on the
    host's clock; `offset` maps the profiler's clock onto it (host =
    profiler + offset)."""
    w0, w1 = window
    inside = [(n, s + offset, e + offset) for n, s, e in events if s + offset < w1 and e + offset > w0]
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in inside]
    busy = busy_intervals(clipped)
    by_name: dict[str, float] = defaultdict(float)
    for n, s, e in clipped:
        by_name[n] += e - s
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((spans.at(s), e - s))
    gap_by: dict[str, float] = defaultdict(float)
    for name, g in gaps:
        gap_by[name] += g
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": sum(e - s for s, e in busy), "window_s": w1 - w0,
            "launches": sum(1 for n, _, _ in clipped if is_kernel(n)),
            "kernels": [(n, s) for n, s in ops if is_kernel(n)],
            "device_ops": [[n[:120], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps, key=lambda x: -x[1])[:top]],
            "idle_by_span": dict(gap_by)}
