"""Reductions of the program's own spans and counters
(freepose_tpu_torch/utils/timing.py), which the per-layer metrics of a
traced run read from the program's newest tracing session: the profiled
video's (two videos' where the first profile recorded no kernel; the
program's own frame counters count the same videos).

A record is (name, parent, t0_ns, t1_ns) on CLOCK_MONOTONIC, all on one
thread, so spans nest as their intervals do. A `wait.<name>` span is the
host blocked on the card; a layer's host time is its outermost spans' time
less the outermost wait spans inside them. A program without the tracer
(or with no session) gives None, and the metric is left out."""
from __future__ import annotations

from typing import Callable


def session():
    """(records, counts) of the program's newest tracing session, or None."""
    try:
        from freepose_tpu_torch.utils import timing
    except ImportError:
        return None
    records, counts = getattr(timing, "records", None), getattr(timing, "counts", None)
    if not records or counts is None:
        return None
    return list(records), dict(counts)


def nested(records) -> list[tuple[str, int, int, tuple[str, ...]]]:
    """(name, t0, t1, names of the spans around it, outermost first) for
    every record, in the order the spans opened."""
    out, stack = [], []  # stack: (name, t1)
    for name, _parent, t0, t1 in sorted(records, key=lambda r: (r[2], -r[3])):
        while stack and stack[-1][1] <= t0:
            stack.pop()
        out.append((name, t0, t1, tuple(n for n, _ in stack)))
        stack.append((name, t1))
    return out


def is_wait(name: str) -> bool:
    return name.startswith("wait.")


def host_ns(records, select: Callable[[str], bool]) -> int:
    """The time of the outermost spans `select` takes, less the outermost
    wait spans nested in them (a selected wait span counts whole)."""
    total = 0
    for name, t0, t1, around in nested(records):
        in_sel = any(select(n) for n in around)
        if select(name) and not in_sel:
            total += t1 - t0
        elif is_wait(name) and in_sel and not any(is_wait(n) for n in around):
            total -= t1 - t0
    return total


def host_ms_per_frame(select: Callable[[str], bool], counter: str):
    """Host ms of the spans `select` takes (host_ns) per `counter`, or None
    where the program recorded no session or none of those spans."""
    s = session()
    if s is None or not s[1].get(counter) or not any(select(r[0]) for r in s[0]):
        return None
    return host_ns(s[0], select) / 1e6 / s[1][counter]

