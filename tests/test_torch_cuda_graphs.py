"""The CUDA graph cache and its counts (freepose_tpu_torch/utils/
cuda_graphs.py, utils/timing.py:tally), on the CPU with stand-ins for the
graphs: a key runs eagerly on its first call, is made on its second and
kept after; the newest GRAPH_KEYS keys are kept; a copy starts empty; a
replay counts what its capture counted, and a capture's counts stay out of
the program's counters. The captures themselves are tested on a card
(test_torch_cuda_kernels.py, test_torch_cotracker2_reference.py)."""
import copy

import pytest

from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import GRAPH_KEYS, Graph, GraphCache


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


class _Replayable:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_key_is_made_on_its_second_call_and_kept():
    cache, made = GraphCache(), []

    def make():
        made.append(object())
        return made[-1]

    assert cache.get("a", make) is None and made == [] and cache.seen == {"a": 1}
    first = cache.get("a", make)
    assert first is made[0] and cache.get("a", make) is first and len(made) == 1 and len(cache) == 1


@pytest.mark.parametrize("n_keys", [GRAPH_KEYS + 1, GRAPH_KEYS + 3])
def test_the_newest_keys_are_kept(n_keys):
    cache = GraphCache()
    for key in range(n_keys):
        cache.get(key, object)
        cache.get(key, object)
    assert list(cache.graphs) == list(range(n_keys - GRAPH_KEYS, n_keys))
    assert cache.get(0, object) is not None  # seen twice before: made again at once
    assert list(cache.graphs) == [*range(n_keys - GRAPH_KEYS + 1, n_keys), 0]


def test_a_copy_is_empty_and_clear_keeps_the_keys_seen():
    cache = GraphCache()
    for _ in range(2):
        cache.get("a", object)
    copied = copy.deepcopy({"cache": cache})["cache"]
    assert len(copied) == 0 and copied.seen == {} and len(cache) == 1
    cache.clear()
    assert len(cache) == 0 and cache.seen == {"a": 2}
    assert cache.get("a", object) is not None


def test_a_tally_keeps_its_counts_out_of_the_counters_tracing_on_or_off():
    with timing.tally() as outer:
        timing.count("launch.k2", 3)
        with timing.tally() as inner:
            timing.count("launch.k2")
        timing.count("launch.k1")
    assert outer == {"launch.k2": 3, "launch.k1": 1} and inner == {"launch.k2": 1} and timing.counts == {}
    with timing.tracing():
        with timing.tally() as traced:
            timing.count("launch.k2", 2)
        timing.count("frames")
        assert traced == {"launch.k2": 2} and timing.counts == {"frames": 1}


def test_a_replay_counts_what_its_capture_counted():
    stand_in = _Replayable()
    graph = Graph(stand_in, {"launch.k2": 22, "launch.k2.d64": 22})
    graph.replay()  # tracing off: replayed, not counted
    with timing.tracing():
        graph.replay()
        graph.replay()
        assert timing.counts == {"launch.k2": 44, "launch.k2.d64": 44}
    assert stand_in.replays == 3
