"""The CUDA graph cache and its counts (freepose_tpu_torch/utils/
cuda_graphs.py, utils/timing.py:tally), on the CPU with stand-ins for the
graphs: a key runs eagerly on its first call, is made on its second and
kept after; the newest GRAPH_KEYS keys are kept; a copy starts empty; a
replay counts what its capture counted, and a capture's counts stay out of
the program's counters; a segmented capture cuts at spans and its replay
reopens them. The captures themselves are tested on a card
(test_torch_cuda_kernels.py, test_torch_cotracker2_reference.py, and here
SAM2's tracking step and GroundingDINO's forward, marked `cuda`: skipped
without a GPU)."""
import copy

import numpy as np
import pytest
import torch

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


# SAM2's prompt-free tracking step on the card (models/sam2/video.py:
# _TrackGraph): Hiera-L at 1024², bf16, K2 d 256 and K4 inside the capture.

SAM2_FRAMES = 40
SAM2_BOXES = ([80.0, 60.0, 300.0, 260.0], [320.0, 120.0, 560.0, 330.0])


@pytest.fixture
def cuda():
    """The card, with tracing on for the test (launches and graphs are counted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with timing.tracing():
        yield torch.device("cuda")


def _sam2_video(device) -> torch.Tensor:
    """A seeded 40-frame 360x640 uint8 video on the card: two boxes drift
    over noise."""
    rng = np.random.default_rng(5)
    frames = (rng.random((SAM2_FRAMES, 360, 640, 3)) * 80).astype(np.uint8)
    for t in range(SAM2_FRAMES):
        for (x0, y0, x1, y1), colour in zip(SAM2_BOXES, ((200, 60, 60), (60, 200, 90))):
            frames[t, int(y0) + t:int(y1) + t, int(x0) + 2 * t:int(x1) + 2 * t] = colour
    return torch.as_tensor(frames, device=device)


def _propagate(predictor, frames) -> tuple[torch.Tensor, torch.Tensor, object]:
    """propagate_batched of the two box-prompted objects -> (low-res masks
    [T, 2, g, g], high-res masks [T, 2, H, W], the final ObjectState)."""
    from freepose_tpu_torch.models.sam2.video import Sam2VideoModel

    state = predictor.init_state(frames)
    for i, box in enumerate(SAM2_BOXES):
        predictor.add_new_points_or_box(state, 0, obj_id=i, box=box)
    step, last = Sam2VideoModel.track_step, {}

    def recorded(self, *args, **kwargs):
        last["state"], out = step(self, *args, **kwargs)
        return last["state"], out

    Sam2VideoModel.track_step = recorded
    try:
        batches = list(predictor.propagate_batched(state))
    finally:
        Sam2VideoModel.track_step = step
    return torch.cat([b[1] for b in batches]), torch.cat([b[2] for b in batches]), last["state"]


def _sam2_graph_counts() -> tuple[int, int]:
    return timing.counts.get("sam2.graph_captures", 0), timing.counts.get("sam2.graph_replays", 0)


@pytest.mark.cuda
def test_sam2_graphed_tracking_equals_eager(cuda, monkeypatch):
    """Two objects over 40 frames at the production config: the eager
    propagation, then a first video on graphs (its first tracking step
    eager, the second captures, the rest replay) and a second video that
    replays on every tracking frame with no new capture. Masks and the
    final state equal the eager run's bit for bit; K2 d 256 and K4 count a
    launch per layer of each step, the capture's warm-up included."""
    from freepose_tpu_torch.models.sam2 import video
    from freepose_tpu_torch.models.sam2.video import STATE_TENSORS
    from freepose_tpu_torch.scripts.extract_proposals_ground_video import load_video_predictor

    predictor = load_video_predictor(None, device=cuda)
    frames = _sam2_video(cuda)
    layers, tracking = predictor.config.mem.num_layers, SAM2_FRAMES - 1
    with monkeypatch.context() as m:
        m.setattr(video, "track_graph_key", lambda *args: None)
        eager = _propagate(predictor, frames)
    assert _sam2_graph_counts() == (0, 0)
    k4 = timing.counts.get("launch.k4", 0)
    first = _propagate(predictor, frames)
    assert _sam2_graph_counts() == (1, tracking - 1) and len(predictor.model._graphs) == 1
    assert timing.counts["launch.k4"] - k4 == layers * (tracking + 1)
    second = _propagate(predictor, frames)
    assert _sam2_graph_counts() == (1, 2 * tracking - 1)
    assert timing.counts["launch.k4"] - k4 == layers * (2 * tracking + 1)
    (graph,) = predictor.model._graphs.graphs.values()
    assert all(getattr(second[2], f) is getattr(graph.state, f) for f in STATE_TENSORS)
    for run in (first, second):
        assert torch.equal(run[0], eager[0]) and torch.equal(run[1], eager[1])
        for f in STATE_TENSORS:
            assert torch.equal(getattr(run[2], f), getattr(eager[2], f)), f
        assert (run[2].ring_pos, run[2].ptr_ring_pos) == (eager[2].ring_pos, eager[2].ptr_ring_pos)


class _StandInGraph:
    """A stand-in for torch.cuda.CUDAGraph that logs its capture and replays."""

    log: list = []

    def __init__(self):
        self.i = sum(1 for e in self.log if e[0] == "begin")

    def capture_begin(self, pool=None):
        self.log.append(("begin", self.i))

    def capture_end(self):
        self.log.append(("end", self.i))

    def replay(self):
        self.log.append(("replay", self.i))


def test_segmented_capture_cuts_at_spans_and_replays_them(monkeypatch):
    """A segmented capture (utils/cuda_graphs.py:_Segmenter, Segmented) on the
    CPU with stand-in graphs: every span's open cuts the capture, a close
    named to it cuts too, other closes follow the graph they end in; the
    replay reopens the spans around the graphs in the eager order, with the
    eager nesting, and adds the capture's counts."""
    from freepose_tpu_torch.utils import cuda_graphs

    _StandInGraph.log = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    cuts = cuda_graphs._Segmenter(None, {"gdino.deform"})

    def step():
        timing.count("gdino.images")
        with timing.span("gdino.text"):
            pass
        with timing.span("gdino.encoder"):
            with timing.span("gdino.deform"):
                pass
        with timing.span("gdino.decoder"):
            pass

    with timing.tally() as counts:
        timing._segmenter = cuts
        try:
            step()
        finally:
            timing._segmenter = None
    items = cuts.finish()
    kinds = [(k, x if k != "graph" else x.i) for k, x in items]
    assert kinds == [("enter", "gdino.text"), ("graph", 0), ("exit", "gdino.text"), ("enter", "gdino.encoder"),
                     ("graph", 1), ("enter", "gdino.deform"), ("graph", 2), ("exit", "gdino.deform"), ("graph", 3),
                     ("exit", "gdino.encoder"), ("enter", "gdino.decoder"), ("graph", 4), ("exit", "gdino.decoder")]
    assert timing.records == [] and counts == {"gdino.images": 1}
    with timing.tracing():
        cuda_graphs.Segmented(items, counts).replay()
        spans = [(name, parent) for name, parent, _, _ in timing.records]
        assert dict(timing.counts) == {"gdino.images": 1}
    assert sorted(spans) == sorted([("gdino.text", None), ("gdino.deform", "gdino.encoder"),
                                    ("gdino.encoder", None), ("gdino.decoder", None)])
    assert [e for e in _StandInGraph.log if e[0] == "replay"] == [("replay", i) for i in range(5)]


@pytest.mark.cuda
def test_graphed_grounding_dino_equals_eager(cuda):
    """GroundingDINO at GDINO_TEST in bf16 on the card: a key's first call
    runs eagerly, its second captures and replays, later calls replay; every
    replay's logits and boxes equal the eager forward's bit for bit, and a
    replay under tracing opens the eager forward's spans and counts."""
    import dataclasses

    from freepose_tpu_torch.models.grounding_dino import GDINO_TEST, GroundingDinoDetector, prepare_detection_image

    bf = torch.bfloat16
    cfg = dataclasses.replace(GDINO_TEST, dtype=bf, swin=dataclasses.replace(GDINO_TEST.swin, dtype=bf),
                              text=dataclasses.replace(GDINO_TEST.text, dtype=bf))
    det = GroundingDinoDetector(cfg, image_size=160, device=cuda)
    images = [(np.random.default_rng(i).random((120, 160, 3)) * 255).astype(np.uint8) for i in range(3)]
    with torch.inference_mode():
        eager = [det.model(prepare_detection_image(torch.as_tensor(im, device=cuda), 160)[None],
                           *det._text_inputs(det._prompt_ids(None, "objects."), 1)) for im in images]
    outs = [det.forward_images([im]) for im in images + images[:1]]
    torch.cuda.synchronize()
    assert timing.counts.get("gdino.graph_captures") == 1 and timing.counts.get("gdino.graph_replays") == 3
    for (logits, boxes), (ref_logits, ref_boxes) in zip(outs, eager + eager[:1]):
        assert torch.equal(logits, ref_logits) and torch.equal(boxes, ref_boxes)
    timing.reset()
    det.forward_images([images[1]])
    names = [r[0] for r in timing.records]
    assert names.count("gdino.deform") == cfg.encoder_layers + cfg.decoder_layers
    assert {"gdino.text", "gdino.backbone", "gdino.encoder", "gdino.select", "gdino.decoder"} <= set(names)
    assert timing.counts["gdino.images"] == 1 and timing.counts["gdino.graph_replays"] == 1
