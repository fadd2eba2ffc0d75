"""Per-stage wall-clock timing, and the program's spans and counters.

`StageTimer` is the counterpart of freepose_tpu.utils.timing.StageTimer.
PyTorch returns from a CUDA call before the card finishes, so each stage
synchronizes CUDA at entry and exit (when a card is present) and the totals
are real stage times; they flow into the BOP CSV `time` column.

`span`, `wait` and `count` trace the program where it does its work. Tracing
is on while a torch.profiler records (any activities) and inside a
`tracing()` block; otherwise each call costs one flag check, records
nothing and synchronizes nothing. When on, a span:

- enters `torch.profiler.record_function(name)`, so a profiler trace holds
  the program's ranges on its own clock, kernels tied to them by
  correlation id;
- appends `(name, parent, t0_ns, t1_ns)` to `records` when it closes:
  `parent` is the name of the span open around it (None at the top), the
  times are `time.perf_counter_ns()` (CLOCK_MONOTONIC); spans are opened by
  one thread, so they nest as their intervals do;
- never synchronizes.

A `wait.<name>` span marks the host blocked on the card (a host copy, an
event), so a layer's host time is its spans' time less that of the wait
spans nested in them. `counts` holds the counters (frames, kernel
launches: `launch.<kernel>`). Inside a `tally()` block every count goes to
the block's own dict instead, tracing on or off: a CUDA graph's capture
counts there the kernels each replay runs (utils/cuda_graphs.py).

`records` and `counts` hold the newest session only: a span or count made
with tracing on after a span ran with tracing off starts a new session, as
does entering `tracing()`. So a warm-up and untraced runs leave a profiled
run's records in place, and the next traced run replaces them.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _profiler

records: list[tuple[str, str | None, int, int]] = []
counts: dict[str, int] = {}
_forced = 0  # depth of open tracing() blocks
_stale = False  # a span ran with tracing off since the session began
_open: list[str] = []  # names of the spans open now, outermost first
_tally: dict[str, int] | None = None  # the counts of the open tally() block
_segmenter = None  # a capture cutting its step at the step's spans (utils/cuda_graphs.py:capture_segmented)


class _Off:
    """The context manager every span returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self.name)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _open.pop()
        records.append((self.name, self.parent, self.t0, t1))
        return False


def reset() -> None:
    """Start a new session: drop every record and count."""
    global _stale
    records.clear()
    counts.clear()
    _stale = False


class _Cut:
    """A span met while a segmented capture runs: it tells the capture,
    which cuts its graph there and replays the span around the parts."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _segmenter.enter(self.name)
        return self

    def __exit__(self, *exc):
        _segmenter.exit(self.name)
        return False


def span(name: str):
    """A context manager around the work of `name` (see the module's
    docstring); while tracing is off, the shared no-op."""
    global _stale
    if _segmenter is not None:
        return _Cut(name)
    if not (_forced or _profiler._is_profiler_enabled):
        _stale = True
        return _OFF
    if _stale:
        reset()
    return _Span(name)


def wait(name: str):
    """`span("wait." + name)`: the host blocked on the card."""
    global _stale
    if not (_forced or _profiler._is_profiler_enabled):
        _stale = True
        return _OFF
    return span("wait." + name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while tracing is on (to the open
    tally() block's, if any)."""
    if _tally is not None:
        _tally[name] = _tally.get(name, 0) + n
        return
    if not (_forced or _profiler._is_profiler_enabled):
        return
    if _stale:
        reset()
    counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Tracing on without a profiler (nested blocks keep it on); the
    outermost block starts a new session."""
    global _forced
    if not _forced:
        reset()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


@contextlib.contextmanager
def tally():
    """The counts made inside, tracing on or off, gathered in the dict it
    yields and kept out of `counts`."""
    global _tally
    outer, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = outer


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates wall-clock per named stage; each stage is also a span."""

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
            with span(name):
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
