"""The program's spans and counters (freepose_tpu_torch/utils/timing.py), on
the CPU, and the readers of the per-layer metrics built on them
(benchmark/program_spans.py, benchmark/metrics/).

- Off (no profiler, no tracing() block): every span is one shared no-op,
  nothing is recorded or counted.
- On under a CPU torch.profiler: the program's names are profiler ranges,
  nested as opened, and records.
- A layer's host time leaves out the wait spans nested in it.
- Sessions: a profiled run after an untraced span starts a new session; a
  second profiled run right after the first adds to it.
- The tiny coupled video path inside tracing(): SAM2 (tests/
  test_torch_coupled_video.py's tiny config) -> proposals_from_masks_video ->
  AutoRefineChain (the tiny refine of test_torch_cuda_kernels) ->
  StreamingInliers records every span of the path, counts its frames, and
  closes no SAM2 span across a yield; the tiny chain on a trajectory that
  overflows its miss bucket records the re-dispatch.
- Each metric reader on synthetic records.
"""
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program_spans
from freepose_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def _names():
    return [r[0] for r in timing.records]


def test_off_returns_the_shared_noop_and_records_nothing():
    a, b, w = timing.span("a"), timing.span("b"), timing.wait("c")
    assert a is b is w and not hasattr(a, "gen")  # one object, no generator behind it
    with a:
        timing.count("frames", 3)
        with timing.span("inner"):
            pass
    assert timing.records == [] and timing.counts == {}


def test_spans_are_profiler_ranges_nested_as_opened():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("outer"):
            with timing.span("inner"):
                torch.ones(8) + 1
            with timing.wait("card"):
                pass
        timing.count("frames", 2)
    events = {e.name: e for e in prof.events()}
    assert {"outer", "inner", "wait.card"} <= set(events)
    outer = events["outer"].time_range
    for name in ("inner", "wait.card"):
        r = events[name].time_range
        assert outer.start <= r.start and r.end <= outer.end
    assert [(n, p) for n, p, _, _ in timing.records] == [("inner", "outer"), ("wait.card", "outer"),
                                                          ("outer", None)]
    assert all(t0 <= t1 for _, _, t0, t1 in timing.records) and timing.counts == {"frames": 2}


def test_wait_time_is_left_out_of_host_time():
    with timing.tracing():
        with timing.span("layer"):
            time.sleep(0.01)
            with timing.span("part"):
                with timing.wait("copy"):
                    time.sleep(0.02)
        with timing.wait("outside"):
            pass
    rec = {r[0]: r for r in timing.records}
    layer = rec["layer"][3] - rec["layer"][2]
    wait = rec["wait.copy"][3] - rec["wait.copy"][2]
    assert wait >= 20_000_000
    assert program_spans.host_ns(timing.records, lambda n: n == "layer") == layer - wait
    assert program_spans.host_ns(timing.records, lambda n: n == "part") == \
        rec["part"][3] - rec["part"][2] - wait
    assert program_spans.host_ns(timing.records, program_spans.is_wait) == \
        wait + rec["wait.outside"][3] - rec["wait.outside"][2]


def test_a_new_session_resets_the_records():
    with timing.tracing():
        with timing.span("first"):
            pass
    assert _names() == ["first"]
    with timing.span("untraced"):  # off: the records stay, the session ends
        pass
    assert _names() == ["first"]
    for name in ("second", "third"):  # two profiled runs in a row: one session
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span(name):
                timing.count("frames")
    assert _names() == ["second", "third"] and timing.counts == {"frames": 2}
    with timing.tracing():
        assert timing.records == [] and timing.counts == {}


def test_stage_timer_stages_are_spans():
    t = timing.StageTimer(sync=False)
    with timing.tracing():
        with t.stage("detect"):
            pass
    assert _names() == ["detect"] and t.counts["detect"] == 1


# ------------------------------------------------------------ the coupled path

SAM2_SPANS = {"sam2.batch", "sam2.trunk", "sam2.memory_gather", "sam2.memory_attention", "sam2.decoder",
              "sam2.memory_encoder", "sam2.postprocess"}
REFINE_SPANS = {"refine.step", "refine.query_features", "wait.refine.miss_count", "refine.miss", "refine.rescore",
                "refine.drain", "wait.refine.result"}
OTHER_SPANS = {"stage", "proposals.video", "inliers.dispatch", "inliers.finalize", "wait.inliers"}


@pytest.fixture(scope="module")
def refine():
    """The tiny refine of the card tests (DINOv2 of 2 layers, 84² renders,
    200 fine views, a 12-slot cache) and its mesh."""
    from tests.test_torch_cuda_kernels import _bumpy_sphere, _refine_setup

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield _refine_setup("cpu"), _bumpy_sphere()
    torch.set_num_threads(n)


def _tiny_refiner():
    from freepose_tpu_torch.models.cotracker import PointTracker
    from freepose_tpu_torch.models.dinov2 import DinoFeatureExtractor, DinoV2Config
    from freepose_tpu_torch.ops.rasterizer import RasterSettings
    from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner

    fe = DinoFeatureExtractor(DinoV2Config(hidden_size=32, num_layers=2, num_heads=2, image_size=56), device="cpu")
    return TrackingRefiner(feature_fn=lambda im: fe(im, layer=None, feature_type="patch"),
                           tracker=PointTracker(device="cpu"), max_vertices=512, max_faces=1024,
                           n_surface_samples=2000, device="cpu",
                           settings=RasterSettings(resolution=518, tile=37, max_faces_per_tile=128))


def test_the_coupled_path_records_its_spans_and_frames(refine):
    from freepose_tpu_torch.datasets.video import stage_frames_hbm
    from freepose_tpu_torch.models.convert import random_sam2_video_params
    from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
    from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain
    from freepose_tpu_torch.pipeline.proposals import proposals_from_masks_video
    from freepose_tpu_torch.pipeline.tracking_refiner import StreamingInliers
    from freepose_tpu_torch.scripts.common import tiny_sam2_video_config

    est, mesh = refine
    pred = Sam2VideoPredictor(tiny_sam2_video_config(), random_sam2_video_params(tiny_sam2_video_config(), seed=5),
                              device="cpu")
    frames = (np.random.default_rng(1).random((7, 48, 56, 3)) * 255).astype(np.uint8)
    k = np.asarray([[60.0, 0, 28], [0, 60.0, 24], [0, 0, 1]], np.float32)
    yielded = []
    with timing.tracing():
        staged = stage_frames_hbm(frames, bucket=8, device="cpu")
        state = pred.init_state(staged)
        pred.add_new_points_or_box(state, 0, obj_id=0, box=np.array([5.0, 5.0, 40.0, 40.0], np.float32))
        chain = AutoRefineChain(est, mesh, "ck", neighborhood_deg=40.0, lag=2, miss_bucket=2)
        conf = StreamingInliers(_tiny_refiner(), mesh, staged, k, chunk=4)
        n_sam2 = n_refine = fed = 0
        for ts, _lows, highs, frames_b in pred.propagate_batched(state, chunk=3):
            yielded.append(time.perf_counter_ns())
            n_sam2 += len(ts)
            crops, cmasks, bboxes = proposals_from_masks_video(frames_b, highs[:, 0], 84, 0.2)
            for z, t in enumerate(ts):
                if t == 0:
                    conf.add(0, est.fine_poses[5].numpy())
                    continue
                chain.submit(crops[z], cmasks[z], est.renderer.k, bboxes[z], 0.25,
                             prev_pose=est.fine_poses[5] if t == 1 else None)
                n_refine += 1
            while fed < len(chain.results):
                conf.add(fed + 1, chain.results[fed][0])
                fed += 1
        results = chain.finalize_all()
        while fed < len(results):
            conf.add(fed + 1, results[fed][0])
            fed += 1
        inliers, _ = conf.finalize()
    names = set(_names())
    assert SAM2_SPANS | REFINE_SPANS | OTHER_SPANS <= names, names  # the cold refine frame misses
    assert n_sam2 == 7 and timing.counts["sam2.frames"] == n_sam2 and len(inliers) == 7
    assert timing.counts["refine.frames"] == n_refine == 6 and timing.counts["inliers.frames"] == 7
    # No SAM2 span is open while the consumer works between yields.
    for name, _, t0, t1 in timing.records:
        if name.startswith("sam2."):
            assert not any(t0 < y < t1 for y in yielded), name
    # finalize_all's drain is outermost; submit's drains nest in their step.
    drains = [p for n, p, _, _ in timing.records if n == "refine.drain"]
    assert drains.count(None) == 1 and set(drains) == {"refine.step", None}


def test_a_redispatch_is_a_span_in_the_drain(refine):
    from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain

    est, mesh = refine
    frames = []
    for gi in (5, 6, 7, 60, 61, 5, 120, 121, 6, 7):
        rgb, depth = est.renderer.render_from_poses(mesh, est.fine_poses[gi][None])
        props, masks, boxes = est.renderer.generate_proposals(rgb, depth)
        frames.append((props[0], masks[0], boxes[0].float()))
    chain = AutoRefineChain(est, mesh, "jump", neighborhood_deg=40.0, lag=2, miss_bucket=2)
    with timing.tracing():
        for i, (prop, mask, box) in enumerate(frames):
            chain.submit(prop, mask, est.renderer.k, box, 0.25, prev_pose=est.fine_poses[5] if i == 0 else None)
        chain.finalize_all()
    assert chain.n_full_redispatch > 0
    redispatch = [p for n, p, _, _ in timing.records if n == "refine.redispatch"]
    assert redispatch == ["refine.drain"] * chain.n_full_redispatch
    assert timing.counts["refine.frames"] == len(frames)
    # Every step reads its miss count once, a re-dispatched one too.
    names = _names()
    assert names.count("wait.refine.miss_count") == names.count("refine.query_features") > len(frames)
    assert {p for n, p, _, _ in timing.records if n == "wait.refine.miss_count"} == {"refine.step",
                                                                                     "refine.redispatch"}


# ------------------------------------------------------------ metric readers

def _reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


MS = 1_000_000
# Two frames: each SAM2 batch holds a trunk (1 ms wait inside), memory parts,
# a decoder; a refine step with a nested drain and its waits; the inliers'
# dispatch and finalize; a stage span outside every layer.
RECORDS = [
    ("stage", None, 0, 5 * MS),
    ("wait.x", "sam2.trunk", 12 * MS, 13 * MS),
    ("sam2.trunk", "sam2.batch", 10 * MS, 20 * MS),
    ("sam2.memory_gather", "sam2.batch", 20 * MS, 22 * MS),
    ("sam2.memory_attention", "sam2.batch", 22 * MS, 25 * MS),
    ("sam2.decoder", "sam2.batch", 25 * MS, 29 * MS),
    ("sam2.memory_encoder", "sam2.batch", 29 * MS, 31 * MS),
    ("sam2.batch", None, 10 * MS, 40 * MS),
    ("wait.refine.miss_count", "refine.step", 42 * MS, 44 * MS),
    ("wait.refine.result", "refine.drain", 46 * MS, 49 * MS),
    ("refine.drain", "refine.step", 45 * MS, 50 * MS),
    ("refine.step", None, 41 * MS, 52 * MS),
    ("inliers.dispatch", None, 53 * MS, 55 * MS),
    ("wait.inliers", "inliers.finalize", 57 * MS, 60 * MS),
    ("inliers.finalize", None, 56 * MS, 61 * MS),
    ("wait.refine.result", "refine.drain", 63 * MS, 64 * MS),
    ("refine.drain", None, 62 * MS, 66 * MS),
]
COUNTS = {"sam2.frames": 2, "refine.frames": 2, "inliers.frames": 2}


@pytest.mark.parametrize("metric,want", [
    ("sam2_host_ms_per_frame.video", (30 - 1) / 2),
    ("sam2_trunk_host_ms_per_frame.video", (10 - 1) / 2),
    ("sam2_memory_host_ms_per_frame.video", (2 + 3 + 2) / 2),
    ("refine_host_ms_per_frame.video", (11 - 2 - 3 + 4 - 1) / 2),
    ("inliers_host_ms_per_frame.video", (2 + 5 - 3) / 2),
    ("host_wait_ms_per_frame.video", (1 + 2 + 3 + 3 + 1) / 2),
    ("host_waits_per_frame.video", 5 / 2),
])
def test_metric_readers_on_synthetic_records(monkeypatch, metric, want):
    read = _reader(metric)
    assert read({}) is None  # no session: the metric is left out
    monkeypatch.setattr(timing, "records", list(RECORDS))
    monkeypatch.setattr(timing, "counts", dict(COUNTS))
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(timing, "counts", {})
    assert read({}) is None  # no frame counter: nothing to divide by
