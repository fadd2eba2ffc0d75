"""CoTracker2 of the PyTorch port against the benchmark's plain float32
reference (benchmark/reference/cotracker2.py: F.conv2d, F.instance_norm,
F.grid_sample, attention written out, the full correlation volumes) at
COTRACKER2_TEST, on seeded random weights in the released key layout
(benchmark/reference/smooth_check.cotracker2_weights), loaded as they are by
both; and smooth_track with CoTracker2 on a tiny staged video against the
reference chain (reference tracks, frozen EPnP, frozen smoothing) from the
program's own correspondences, with the program's spans and counters.

Tolerances, each with its reason:
  * the encoder within 1e-4: the same fp32 convolutions, the stage resizes
    as a hat-weight matrix product in the port and F.interpolate in the
    reference (rounding of O(1) activations);
  * one window at one iteration: tracks within 1e-4 feature pixels and
    visibility logits within 1e-5: bilinear taps read by index against
    grid_sample, and softmax with -1e30 against the release's additive
    -finfo.max bias, round alike to a few ulp;
  * random weights make the iterated tracker chaotic (with the flow head as
    drawn, a 1e-3 change of the input's 0-255 pixels moves a track by 7-12
    pixels at two iterations), so the multi-window forward, the predictor
    and the chain run with the flow head scaled by 0.02, as
    tests/test_torch_cotracker2.py does: there the same change moves a
    track by 2.5e-4-1.2e-3 pixels, and the port stays within 2e-3 pixels of
    the reference (4e-3 in input pixels through the predictor's resize);
  * the chain's EPnP poses within 0.05 degrees and its smoothed track
    within 0.05 degrees: EPnP from tracks 4e-3 pixels apart on a 72 x 128
    frame.
"""
from __future__ import annotations

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import synth
from benchmark.reference import cotracker2 as ref
from benchmark.reference import smooth_check
from benchmark.reference.frozen.pnp import epnp
from benchmark.reference.frozen.se3 import smooth_transforms
from benchmark.traffic.video_smooth import jittered, true_poses
from freepose_tpu_torch.models import cotracker2 as ct2
from freepose_tpu_torch.utils import timing

CFG = ct2.COTRACKER2_TEST
FIELDS = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}


def bench_cfg(flow_head_scale: float, visibility_bias: float = 0.0) -> dict:
    return {"cotracker2": dict(FIELDS, model_resolution=list(CFG.model_resolution)),
            "random_weights": {"flow_head_scale": flow_head_scale, "visibility_bias": visibility_bias}}


def models(flow_head_scale: float, seed: int = 0, visibility_bias: float = 0.0):
    cfg = bench_cfg(flow_head_scale, visibility_bias)
    w = smooth_check.cotracker2_weights(cfg, seed, "cpu")
    port = ct2.CoTracker2(CFG)
    port.load_state_dict(w)
    plain = ref.CoTracker2(smooth_check.config(cfg))
    plain.load_state_dict(w)
    return port.eval(), plain.eval(), w


QUERIES = torch.tensor([[0, 10.5, 20.0], [0, 40.0, 30.0], [0, 25.0, 12.5], [0, 70.0, 50.0]])


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_matches_the_reference(seed):
    port, plain, _ = models(1.0, seed)
    x = torch.rand(2, 3, 40, 56, generator=torch.Generator().manual_seed(seed)) * 2 - 1
    with torch.no_grad():
        torch.testing.assert_close(port.fnet(x), plain.fnet(x), atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_window_at_one_iteration_matches_the_reference(seed):
    port, plain, _ = models(1.0, seed)
    g = torch.Generator().manual_seed(seed)
    fmaps = torch.randn(8, CFG.latent_dim, 16, 24, generator=g)
    coords = torch.rand(8, 5, 2, generator=g) * torch.tensor([23.0, 15.0])
    feat = torch.randn(8, 5, CFG.latent_dim, generator=g)
    vis = torch.randn(8, 5, generator=g)
    exists = torch.ones(8, 5, dtype=torch.bool)
    exists[:3, 1] = False  # a point whose query frame comes later: its rows attend uniformly
    with torch.no_grad():
        c_port, _, v_port = port.forward_window(fmaps, coords, feat, vis, exists, 1)
        c_ref, v_ref = plain.window(fmaps, coords, feat, vis, exists, 1)
    torch.testing.assert_close(c_port, c_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(v_port, v_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_window_forward_matches_the_reference(seed):
    port, plain, _ = models(0.02, seed)
    video = torch.rand(12, 64, 96, 3, generator=torch.Generator().manual_seed(seed)) * 255
    with torch.no_grad():
        t_port, v_port = port(video, QUERIES)
        t_ref, v_ref = plain(video, QUERIES)
    assert float((t_ref[-1] - t_ref[0]).abs().max()) > 0.05  # the tracks move
    torch.testing.assert_close(t_port, t_ref, atol=2e-3, rtol=0)
    torch.testing.assert_close(v_port, v_ref, atol=2e-3, rtol=0)


def test_predictor_matches_the_reference():
    port, plain, w = models(0.02, 3)
    pred = ct2.CoTracker2Predictor.from_state_dict(w, CFG, support_grid_size=3, device="cpu")
    video = (torch.rand(12, 72, 128, 3, generator=torch.Generator().manual_seed(3)) * 255).to(torch.uint8)
    queries = np.array([[10.0, 20.0], [60.0, 40.0], [100.0, 60.0], [33.5, 51.25]], np.float32)
    tracks, visible = pred.track(video, queries, 0)
    r_tracks, r_prob, r_visible = ref.predict(plain, video.float(), torch.as_tensor(queries), support=3)
    np.testing.assert_allclose(tracks, r_tracks.numpy(), atol=4e-3, rtol=0)
    decided = (r_prob - ref.VISIBILITY_THRESHOLD).abs() > 1e-3  # rounding cannot flip these
    assert np.array_equal(visible[decided.numpy()], r_visible[decided].numpy())
    np.testing.assert_allclose(tracks[0], queries, atol=1e-4, rtol=0)  # the query frame pinned (rescaled)


def test_windows_run_eagerly_on_the_cpu():
    port, _, _ = models(0.02, 0)
    video = torch.rand(12, 64, 96, 3, generator=torch.Generator().manual_seed(0)) * 255
    with torch.inference_mode():
        for _ in range(2):
            port(video, QUERIES)
    assert len(port._graphs) == 0 and port._graphs.seen == {}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_graphed_windows_equal_eager_windows_on_a_card(seed):
    """On a card a window shape's second window on replays its CUDA graphs:
    the same kernels in the same order as the eager windows, so the same
    tracks and visibility, bit for bit. The reference call runs every window
    eagerly: the 12 frames make two windows of one shape, so a plain first
    call would already capture on its second."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are CUDA captures")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        port, _, _ = models(0.02, seed)
        port = port.cuda()
        video = (torch.rand(12, 64, 96, 3, generator=torch.Generator().manual_seed(seed)) * 255).cuda()
        q = QUERIES.cuda()
        with torch.inference_mode():
            with mock.patch.object(port, "_window_graphs", return_value=None):
                eager = port(video, q)
            runs = [port(video, q) for _ in range(3)]  # eager then captured; replayed; replayed
        assert len(port._graphs) == 1
        for tracks, vis in runs:
            torch.testing.assert_close(tracks, eager[0], atol=0, rtol=0)
            torch.testing.assert_close(vis, eager[1], atol=0, rtol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------- the smooth stage
FRAMES, HW, OBJECT_RES, INTERVAL = 7, (72, 128), 32, 3
SPANS = ("smooth.inliers", "smooth.correspondences", "smooth.track", "smooth.pnp", "smooth.transforms",
         "cotracker2.encoder", "cotracker2.window", "cotracker2.corr", "cotracker2.update",
         "wait.cotracker2.queries", "wait.cotracker2.result")
COUNTERS = ("smooth.frames", "smooth.intervals", "cotracker2.frames", "cotracker2.windows", "cotracker2.iters",
            "cotracker2.points")


@pytest.fixture(scope="module")
def smooth_run():
    """A tiny smooth_track with CoTracker2 on a staged 7-frame video, once
    under timing.tracing() and once with tracing off."""
    from freepose_tpu_torch.datasets.video import stage_frames
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.io.mesh import TriMesh
    from freepose_tpu_torch.models.dinov2 import VIT_TEST, DinoFeatureExtractor
    from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner
    from freepose_tpu_torch.scripts.smooth_poses_video import smooth_track

    seed = 11
    torch.manual_seed(seed)
    mesh_np = synth.bumpy_torus(seed, 16, 8)
    video = synth.make_videos(seed, mesh_np, 1, FRAMES, HW, OBJECT_RES, 2.0, "cpu")[0]
    coarse = jittered(seed, true_poses(seed, 1, FRAMES, HW, OBJECT_RES, 2.0, 0.15)[0], 2.0, 0.01)
    # The visibility probe's bias +3: EPnP keeps most points on every frame
    # (with a handful it is ill-conditioned at this size).
    _, plain, w = models(0.02, seed, visibility_bias=3.0)
    pred = ct2.CoTracker2Predictor.from_state_dict(w, CFG, support_grid_size=3, device="cpu")
    vit = DinoFeatureExtractor(VIT_TEST, device="cpu")
    refiner = TrackingRefiner(feature_fn=lambda x: vit(x, layer=None, feature_type="patch"), tracker=pred,
                              device="cpu")
    mesh = TriMesh(*mesh_np).scaled(0.15)
    k = default_video_intrinsics(HW[1], HW[0])
    staged = stage_frames(video["frames"], "cpu")
    kwargs = dict(interval=INTERVAL, pipelined=True, cap=256, keep_coarse_translation=True, cap_buckets=(128, 256))
    tel: dict = {}
    with timing.tracing():
        smoothed, inliers = smooth_track(refiner, mesh, staged, k, coarse, telemetry=tel, **kwargs)
        records, counts = list(timing.records), dict(timing.counts)
    timing.reset()
    again = smooth_track(refiner, mesh, staged, k, coarse, **kwargs)
    return dict(video=video, coarse=coarse, k=k, plain=plain, smoothed=smoothed, inliers=inliers, tel=tel,
                records=records, counts=counts, untraced=again, untraced_records=list(timing.records))


def test_smooth_track_with_cotracker2_matches_the_reference_chain(smooth_run):
    run = smooth_run
    refined = torch.as_tensor(run["coarse"]).clone()
    intervals = run["tel"]["intervals"]
    assert intervals
    moved = 0.0
    for rec in intervals:
        idxs = rec["frames"]
        pad = [min(max(i, 0), FRAMES - 1) for i in idxs] + [idxs[-1]] * (INTERVAL - len(idxs))
        frames = torch.as_tensor(run["video"]["frames"][pad]).float()
        r_tracks, r_prob, r_visible = ref.predict(run["plain"], frames, rec["queries"], support=3)
        np.testing.assert_allclose(rec["tracks"], r_tracks.numpy(), atol=4e-3, rtol=0)
        moved = max(moved, float((r_tracks[-1] - r_tracks[0]).abs().max()))
        decided = (r_prob - ref.VISIBILITY_THRESHOLD).abs() > 1e-3  # rounding cannot flip these
        assert torch.equal(torch.as_tensor(rec["visibility"])[decided], r_visible[decided])
        # EPnP takes the program's visibility: a point near 0.9 that rounding
        # flips changes the set EPnP solves from, not its arithmetic.
        mask = torch.as_tensor(rec["visibility"]) & rec["valid"][None]
        assert int(mask[0].sum()) >= 4
        r_poses = epnp(rec["surface"], r_tracks, run["k"], mask)
        rot = smooth_check.rotation_deg(torch.as_tensor(rec["poses"])[:, :3, :3], r_poses[:, :3, :3])
        assert float(rot.max()) < 0.05
        for li, t in enumerate(idxs):
            refined[t, :3, :3] = r_poses[li, :3, :3]
    assert moved > 0.02
    r_smoothed = smooth_transforms(refined)
    smoothed = torch.as_tensor(run["smoothed"])
    assert float(smooth_check.rotation_deg(smoothed[:, :3, :3], r_smoothed[:, :3, :3]).max()) < 0.05
    torch.testing.assert_close(smoothed[:, :3, 3], r_smoothed[:, :3, 3], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(run["untraced"][0], run["smoothed"])  # tracing changes nothing


def test_smooth_track_traces_its_stages_and_cotracker2(smooth_run):
    run = smooth_run
    names = {r[0] for r in run["records"]}
    assert set(SPANS) <= names, set(SPANS) - names
    counts, intervals = run["counts"], run["tel"]["intervals"]
    assert set(COUNTERS) <= set(counts)
    assert counts["smooth.frames"] == FRAMES
    assert counts["smooth.intervals"] == len(intervals)
    # An interval of 3 frames is one window of 8 (padded); each window runs
    # CFG.iters iterations on the cap's queries and the 3 x 3 support grid.
    assert counts["cotracker2.windows"] == len(intervals)
    assert counts["cotracker2.iters"] == CFG.iters * len(intervals)
    assert counts["cotracker2.points"] == sum(len(r["queries"]) + 9 for r in intervals)
    assert counts["cotracker2.frames"] == CFG.window_len * len(intervals)
    for name in ("cotracker2.corr", "cotracker2.update"):
        assert sum(r[0] == name for r in run["records"]) == CFG.iters * len(intervals)
    parents = {r[0]: r[1] for r in run["records"]}
    assert parents["cotracker2.corr"] == "cotracker2.window" and parents["cotracker2.window"] == "smooth.track"
    from freepose_tpu_torch.scripts.smooth_poses_video import INTERVAL_RECORD

    starts = sorted(r["start"] for r in intervals)
    assert starts == sorted({s for s in range(int(np.argmax(run["inliers"])) % INTERVAL, FRAMES, INTERVAL)})
    for rec in intervals:
        assert tuple(rec) == INTERVAL_RECORD
        assert torch.is_tensor(rec["queries"]) and rec["tracks"].shape == (INTERVAL, len(rec["queries"]), 2)
        assert rec["visibility"].shape == (INTERVAL, len(rec["queries"])) and rec["poses"].shape == (INTERVAL, 4, 4)
    assert isinstance(run["tel"]["inliers_threshold"], float)
    assert run["untraced_records"] == []  # tracing off: no span is recorded
