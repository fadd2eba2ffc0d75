"""CUDA graphs of a model's launch-bound steps, kept by what a call can observe.

A step whose shapes repeat (DINOv2's single-image forward, a CoTracker2
window's iteration) is some hundreds of kernels of microseconds each on a
card; replayed as a graph it is one launch from the host.

- `GraphCache` holds a model's graphs by key: a key's first call runs
  eagerly, its second captures, later calls replay; the newest GRAPH_KEYS
  keys are kept. A deep copy of a cache is empty, so each replica of a model
  (DinoFeatureExtractor.replica, parallel/mesh.py:replicate) captures its own
  graphs on its own device.
- `capture` runs a warm-up of the step once on a side stream outside the
  capture (library handles and workspaces are made there), then captures the
  step's parts on that stream, one graph each, in one memory pool.
- A `Graph`'s replay adds to the program's counters (utils/timing.py) what
  its capture counted, so `launch.<kernel>` counts the kernels each replay
  runs: a capture records its kernels and runs none.
- `capture_segmented` captures a step that opens program spans as a
  sequence of graphs cut where a span opens (and where a span named to it
  closes); its replay (`Segmented`) reopens each span around the graphs it
  held, so a replayed step is traced as its eager run is. The step opens a
  span before its first kernel, and between a span's close and the next
  span's open it launches nothing, unless that close is a cut.
"""
from __future__ import annotations

import gc
from typing import Callable, Hashable, Optional

import torch

from freepose_tpu_torch.utils import timing

GRAPH_KEYS = 2  # keys whose graphs a model keeps (the newest)


class Graph:
    """A captured CUDA graph and the counts its capture made."""

    def __init__(self, graph: torch.cuda.CUDAGraph, counts: dict[str, int]):
        self.graph, self.counts = graph, counts

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.counts.items():
            timing.count(name, n)


def capture(device, warm_up: Callable[[], object], *parts: Callable[[], object]) -> list[Graph]:
    """`warm_up()` once on a side stream of `device`, then each of `parts`
    captured on it as a graph, in order, the graphs in one memory pool. A
    part leaves its outputs where its caller reads them (static tensors a
    replay rewrites)."""
    graphs: list[Graph] = []
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm_up()
        torch.cuda.current_stream(device).wait_stream(side)
        for part in parts:
            graph = torch.cuda.CUDAGraph()
            pool = graphs[0].graph.pool() if graphs else None
            with timing.tally() as counts, torch.cuda.graph(graph, pool=pool, stream=side):
                part()
            graphs.append(Graph(graph, counts))
    return graphs


class Segmented:
    """A step captured by `capture_segmented`: its graphs and span events in
    the step's order, and the counts its capture made."""

    def __init__(self, items: list, counts: dict[str, int]):
        self.items, self.counts = items, counts

    def replay(self) -> None:
        opened = []
        for kind, item in self.items:
            if kind == "graph":
                item.replay()
            elif kind == "enter":
                opened.append(timing.span(item))
                opened[-1].__enter__()
            else:
                opened.pop().__exit__(None, None, None)
        for name, n in self.counts.items():
            timing.count(name, n)


class _Segmenter:
    """Cuts a capture where the step opens a span, and where a span of
    `cut_exits` closes; other closes wait for the graph they end in."""

    def __init__(self, pool, cut_exits: set[str]):
        self.pool, self.cut_exits = pool, cut_exits
        self.items: list = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pending: list = []

    def _end(self) -> None:
        if self.graph is not None:
            self.graph.capture_end()
            self.items.append(("graph", self.graph))
        self.items += self.pending
        self.graph, self.pending = None, []

    def _begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def enter(self, name: str) -> None:
        self._end()
        self.items.append(("enter", name))
        self._begin()

    def exit(self, name: str) -> None:
        if name in self.cut_exits:
            self._end()
            self.items.append(("exit", name))
            self._begin()
        else:
            self.pending.append(("exit", name))

    def finish(self) -> list:
        self._end()
        return self.items


def capture_segmented(device, warm_up: Callable[[], object], step: Callable[[], object],
                      cut_exits: tuple[str, ...] = ()) -> Segmented:
    """`warm_up()` once on a side stream of `device`, then `step()` captured
    on it, cut at its spans (the module's docstring), the graphs in one
    memory pool. The step leaves its outputs where its caller reads them."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm_up()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        gc.collect()
        cuts = _Segmenter(torch.cuda.graph_pool_handle(), set(cut_exits))
        with timing.tally() as counts, torch.cuda.stream(side):
            timing._segmenter = cuts
            try:
                step()
            finally:
                timing._segmenter = None
                items = cuts.finish()
        torch.cuda.current_stream(device).wait_stream(side)
    return Segmented(items, counts)


class GraphCache:
    """A model's graphs by key (see the module's docstring): `graphs` the
    kept ones, oldest first; `seen` the calls of each key not yet kept."""

    def __init__(self):
        self.graphs: dict = {}
        self.seen: dict = {}

    def get(self, key: Hashable, make: Callable[[], object]) -> Optional[object]:
        """The graphs of `key`, made by `make()` on the key's second call;
        None (run eagerly) on its first."""
        graphs = self.graphs.get(key)
        if graphs is None:
            self.seen[key] = self.seen.get(key, 0) + 1
            if self.seen[key] < 2:
                return None
            while len(self.graphs) >= GRAPH_KEYS:
                self.graphs.pop(next(iter(self.graphs)))
            graphs = self.graphs[key] = make()
        return graphs

    def clear(self) -> None:
        """Drop the graphs (the model's tensors moved or were cast); a key
        seen before captures again on its next call."""
        self.graphs.clear()

    def __len__(self) -> int:
        return len(self.graphs)

    def __deepcopy__(self, memo) -> "GraphCache":
        return type(self)()
