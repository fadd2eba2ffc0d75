"""The trace reduction: busy time as the union of device intervals, idle gaps
named by the span the host was in, launches counting kernels only."""
from __future__ import annotations

import pytest

from benchmark.spans import Spans, summarize


def test_busy_time_gaps_and_launches_from_device_events():
    spans = Spans(True)
    spans.records += [("sam2", 0.0, 1.0), ("refine", 1.5, 2.0)]
    events = [("k1", 0.1, 0.3), ("k2", 0.25, 0.4), ("Memcpy HtoD", 1.6, 1.7), ("k3", 2.5, 3.0)]
    out = summarize(events, (0.0, 2.0), spans, offset=0.0)
    assert out["busy_s"] == pytest.approx(0.4)
    assert out["launches"] == 2  # k3 lies outside the window, the copy is no kernel
    assert out["idle_by_span"] == pytest.approx({"sam2": 1.3, "refine": 0.3})
    assert out["idle_gaps"][0] == ["sam2", pytest.approx(1.2)]


def test_an_untraced_run_records_nothing():
    spans = Spans(False)
    with spans.span("sam2"):
        spans.count("images", 3)
    assert spans.records == [] and not spans.counts
