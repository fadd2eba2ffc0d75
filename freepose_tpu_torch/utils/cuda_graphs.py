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
"""
from __future__ import annotations

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
