"""SAM2's graphed tracking step (freepose_tpu_torch/models/sam2/video.py:
_TrackGraph, track_graph_key) on the CPU, at the tiny SAM2 video config.

A CUDA graph cannot be captured here, so `capture` is replaced by a stand-in
that runs each part eagerly at every replay, and the path rule is told the
step runs on a card. Everything else of the graph path runs as on a card:
the static buffers, the frame index and ring slots as device scalars written
by `fill_`, the slot writes through index ops, the state's adoption of the
graphs' tensors and the copies of the outputs. That device-index form must
give the same bits as the eager step's Python ints over 40 frames (both
rings wrap: 6 mask slots, 15 pointer slots), for 2 objects, forward and
reverse, and for two videos stepped in turns on one graph. The path rule
keys only a prompt-free, stride-1 step on a card under inference mode. A
propagation uploads its object indices once, not on every frame. The
graphs' capture and replay are tested on a card (test_torch_cuda_graphs.py).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from freepose_tpu_torch.models.sam2 import video
from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
from freepose_tpu_torch.models.sam2.video import STATE_TENSORS, init_object_state
from freepose_tpu_torch.scripts.common import tiny_sam2_video_config
from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import Graph, GraphCache

N_FRAMES = 40
BOXES = ([4.0, 4.0, 30.0, 30.0], [20.0, 10.0, 60.0, 50.0])
CARD, CPU = torch.device("cuda", 0), torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


@pytest.fixture(scope="module")
def predictor():
    return Sam2VideoPredictor(tiny_sam2_video_config(), device="cpu", seed=3)


@pytest.fixture(scope="module")
def frames():
    return (np.random.default_rng(0).random((N_FRAMES, 64, 64, 3)) * 255).astype(np.uint8)


class _Eager:
    """A stand-in for a captured graph: each replay runs the part."""

    def __init__(self, part):
        self.part = part

    def replay(self):
        self.part()


def _eager_capture(device, warm_up, *parts):
    warm_up()
    return [Graph(_Eager(part), {}) for part in parts]


@contextlib.contextmanager
def _graph_path(predictor):
    """The graph path taken on the CPU, its parts run eagerly; yields the
    model's (fresh) graph cache, dropped again at the end."""
    key = video.track_graph_key
    with pytest.MonkeyPatch.context() as m:
        m.setattr(video, "capture", _eager_capture)
        m.setattr(video, "track_graph_key", lambda config, device, *args: key(config, CARD, *args))
        predictor.model._graphs = GraphCache()
        try:
            yield predictor.model._graphs
        finally:
            predictor.model._graphs = GraphCache()


def _prompts(predictor, boxes):
    """Box prompts as corner points [O, 1, N, 2] and labels [O, 1, N]."""
    cap = predictor.config.max_point_prompts
    pts = np.zeros((len(boxes), cap, 2), np.float32)
    lbl = np.full((len(boxes), cap), -10, np.int64)
    for i, box in enumerate(boxes):
        pts[i, :2] = np.reshape(box, (2, 2))
        lbl[i, :2] = [2, 3]
    return torch.as_tensor(pts)[:, None], torch.as_tensor(lbl)[:, None]


def _embedded(predictor, frames):
    state = predictor.init_state(frames)
    predictor._embed_frames(state, list(range(N_FRAMES)))
    return state


def _steps(predictor, vstate, order, boxes, reverse):
    """The init step on order[0], then a tracking step on each later frame
    -> (ObjectState, each step's outputs)."""
    model = predictor.model
    st = init_object_state(predictor.config, len(boxes))
    pts, lbl = _prompts(predictor, boxes)
    outs = []
    with torch.inference_mode():
        for i, t in enumerate(order):
            pyr, pos = predictor._frame_pyramid(vstate, t)
            if i == 0:
                st, o = model.track_step(st, pyr, pyr[2], pos[2], t, N_FRAMES, points=pts, labels=lbl, is_init=True)
            else:
                st, o = model.track_step(st, pyr, pyr[2], pos[2], t, N_FRAMES, reverse=reverse)
            outs.append(o)
    return st, outs


def _assert_same(a, b):
    st_a, outs_a = a
    st_b, outs_b = b
    for f in STATE_TENSORS:
        assert torch.equal(getattr(st_a, f), getattr(st_b, f)), f
    assert (st_a.ring_pos, st_a.ptr_ring_pos) == (st_b.ring_pos, st_b.ptr_ring_pos)
    assert len(outs_a) == len(outs_b)
    for i, (oa, ob) in enumerate(zip(outs_a, outs_b)):
        assert oa.keys() == ob.keys()
        for name in oa:
            assert torch.equal(oa[name], ob[name]), (i, name)


def _order(reverse):
    return list(range(N_FRAMES - 1, -1, -1)) if reverse else list(range(N_FRAMES))


@pytest.mark.parametrize("reverse", [False, True])
def test_the_device_index_step_equals_the_int_step(predictor, frames, reverse):
    vstate = _embedded(predictor, frames)
    eager = _steps(predictor, vstate, _order(reverse), BOXES, reverse)
    tracked = N_FRAMES - 1  # both rings wrap
    assert (eager[0].ring_pos, eager[0].ptr_ring_pos) == (1 + tracked % 6, 1 + tracked % 15)
    with _graph_path(predictor) as graphs, timing.tracing():
        indexed = _steps(predictor, vstate, _order(reverse), BOXES, reverse)
        counts = dict(timing.counts)
        assert len(graphs) == 1
        (graph,) = graphs.graphs.values()
    _assert_same(indexed, eager)
    # The key's first tracking step runs eagerly, the second captures and
    # replays, every later one replays.
    assert counts.get("sam2.graph_captures") == 1 and counts.get("sam2.graph_replays") == tracked - 1
    assert all(getattr(indexed[0], f) is getattr(graph.state, f) for f in STATE_TENSORS)
    # The outputs are copies: no step's output is a static buffer.
    statics = {id(x) for x in graph.out}
    assert not any(id(v) in statics for o in indexed[1] for v in o.values())


def test_two_videos_in_turns_on_one_graph_equal_each_alone(predictor, frames):
    """Two states step in turns on one key's graphs: each adopts the graphs'
    tensors in its turn and the other keeps a copy of its own, so each ends
    as it does stepped alone and eagerly."""
    vstate = _embedded(predictor, frames)
    order = list(range(12))
    boxes = [BOXES[:1], BOXES[1:]]
    alone = [_steps(predictor, vstate, order, b, False) for b in boxes]
    model = predictor.model
    pts = [_prompts(predictor, b) for b in boxes]
    states = [init_object_state(predictor.config, 1) for _ in boxes]
    outs = [[], []]
    with _graph_path(predictor), torch.inference_mode(), timing.tracing():
        for i, t in enumerate(order):
            pyr, pos = predictor._frame_pyramid(vstate, t)
            for j in range(2):
                if i == 0:
                    states[j], o = model.track_step(states[j], pyr, pyr[2], pos[2], t, N_FRAMES, points=pts[j][0],
                                                    labels=pts[j][1], is_init=True)
                else:
                    states[j], o = model.track_step(states[j], pyr, pyr[2], pos[2], t, N_FRAMES)
                outs[j].append(o)
        counts = dict(timing.counts)
    assert counts.get("sam2.graph_captures") == 1 and counts.get("sam2.graph_replays") == 2 * (len(order) - 1) - 1
    for j in range(2):
        _assert_same((states[j], outs[j]), alone[j])


def _with_stride(cfg, r):
    return dataclasses.replace(cfg, mem=dataclasses.replace(cfg.mem, memory_temporal_stride=r))


@pytest.mark.parametrize("case,device,is_init,prompted,stride,keyed", [
    ("tracking on a card", CARD, False, False, 1, True),
    ("the CPU", CPU, False, False, 1, False),
    ("an init step", CARD, True, True, 1, False),
    ("a mask or point prompt", CARD, False, True, 1, False),
    ("memory stride 2", CARD, False, False, 2, False),
])
def test_the_path_rule(case, device, is_init, prompted, stride, keyed):
    cfg = _with_stride(tiny_sam2_video_config(), stride)
    with torch.inference_mode():
        key = video.track_graph_key(cfg, device, 2, torch.bfloat16, is_init, prompted, True, True, N_FRAMES)
    assert (key is not None) == keyed, case
    if keyed:
        assert key[:6] == (device, 2, torch.bfloat16, True, True, cfg.mem.max_obj_ptrs)


def test_the_path_rule_keys_what_a_replay_depends_on():
    """Outside inference mode a step runs eagerly; a short video's pointer
    window and each other input of the key give keys of their own."""
    cfg = tiny_sam2_video_config()
    args = (cfg, CARD, 1, torch.bfloat16, False, False, False, True)
    assert video.track_graph_key(*args, N_FRAMES) is None
    with torch.inference_mode():
        keys = {video.track_graph_key(*args, N_FRAMES), video.track_graph_key(*args, 5),
                video.track_graph_key(cfg, CARD, 2, torch.bfloat16, False, False, False, True, N_FRAMES),
                video.track_graph_key(cfg, CARD, 1, torch.float32, False, False, False, True, N_FRAMES),
                video.track_graph_key(cfg, CARD, 1, torch.bfloat16, False, False, True, True, N_FRAMES),
                video.track_graph_key(cfg, CARD, 1, torch.bfloat16, False, False, False, False, N_FRAMES)}
    assert len(keys) == 6 and None not in keys


def test_a_swapped_memory_attention_is_a_key_of_its_own(monkeypatch):
    """With the memory attention on flash_attention_auto, the function the
    step would call now is part of the key: a plain stand-in put in its
    place never replays the kernels' graphs."""
    from freepose_tpu_torch.ops import attention

    cfg = tiny_sam2_video_config()
    cfg = dataclasses.replace(cfg, mem=dataclasses.replace(cfg.mem, use_flash=True))
    args = (cfg, CARD, 1, torch.bfloat16, False, False, False, True, N_FRAMES)
    with torch.inference_mode():
        kernels = video.track_graph_key(*args)
        monkeypatch.setattr(attention, "flash_attention_auto", attention.dense_attention_masked)
        plain = video.track_graph_key(*args)
    assert kernels != plain and plain[-1] is attention.dense_attention_masked


@pytest.mark.parametrize("reverse,replays", [(False, 38 + 35), (True, 38 + 38)])
def test_a_graphed_propagation_gives_the_eager_masks(predictor, frames, reverse, replays):
    """A box-prompted group of two objects and a mask-prompted one (on
    frame 3 forward, with the first group on the last frame in reverse)
    through propagate_in_video: the same logits on every frame, graphed
    and eager; each group's first tracking step runs eagerly."""
    def run():
        state = predictor.init_state(frames)
        first = N_FRAMES - 1 if reverse else 0
        predictor.add_new_points_or_box(state, first, obj_id=0, box=BOXES[0])
        predictor.add_new_points_or_box(state, first, obj_id=1, box=BOXES[1])
        mask = np.zeros(frames.shape[1:3], bool)
        mask[10:40, 20:50] = True
        predictor.add_new_mask(state, first if reverse else 3, obj_id=2, mask=mask)
        return [(t, low, high) for t, _, low, high in
                predictor.propagate_in_video(state, start_frame_idx=first, reverse=reverse)]

    eager = run()
    with _graph_path(predictor), timing.tracing():
        graphed = run()
        counts = dict(timing.counts)
    assert [t for t, _, _ in graphed] == [t for t, _, _ in eager] and len(eager) == N_FRAMES
    for (t, low_g, high_g), (_, low_e, high_e) in zip(graphed, eager):
        np.testing.assert_array_equal(low_g, low_e, err_msg=f"frame {t}")
        np.testing.assert_array_equal(high_g, high_e, err_msg=f"frame {t}")
    assert counts.get("sam2.graph_captures") == 2 and counts.get("sam2.graph_replays") == replays


def test_a_propagation_uploads_its_object_indices_once(predictor, frames):
    """No per-frame `wait.sam2.object_index`: the groups' indices reach the
    device in one wait at the propagation's start."""
    state = predictor.init_state(frames[:12])
    predictor.add_new_points_or_box(state, 0, obj_id=0, box=BOXES[0])
    predictor.add_new_points_or_box(state, 2, obj_id=1, box=BOXES[1])
    with timing.tracing():
        n = sum(1 for _ in predictor.propagate_in_video(state))
        names = [r[0] for r in timing.records]
        frames_counted = timing.counts.get("sam2.frames")
    assert n == 12 and frames_counted == 12
    assert "wait.sam2.object_index" not in names
    assert names.count("wait.sam2.group_index") == 1
