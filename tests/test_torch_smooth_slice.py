"""The track-refine (smooth) slice through both packages' CLIs, on the CPU.

smooth_poses_video and filter_predictions, JAX CLI and port CLI in-process,
on one tiny workspace: a coloured blob mesh, 6 rendered 240x320 frames of a
slow rotation over a textured background with +-20 of sensor noise, a coarse
CSV of one row per frame (the true poses, rotated a few degrees off),
FREEPOSE_TINY_MODELS=1 (VIT_TEST in place of DINOv2-B) with one .npz of its
JAX weights, --interval 3, a static cap (--cap-buckets equal to --cap).
Trackers: ZNCC, and CoTracker2 at a COTRACKER2_TEST --tracker-config from one
.npz of random_cotracker2_params; each pipelined and --exact-intervals. Both
run fp32 with plain attention and the plain rasterizer.

The tracked CSVs agree row for row; R within 0.05 degrees (geodesic; ~0.012
measured) and t within 1e-5 m (the coarse translation, smoothed). The
noise matters: ZNCC of an exactly flat patch normalises float rounding
residue, and there each package picks its own candidate; on noiseless
smooth shading the subpixel step divides by a peak curvature near 1e-4 and
fp32 rounding moves tracks by tenths of a pixel. The filter_predictions
JSONs are identical. Two faults of
the JAX script are not copied, and the port's own runs show the repairs:
with CoTracker2 the default --cap-buckets leave the cap static, and a --cap
above 512 is the largest bucket.

smooth_track itself, both packages on the workspace's video staged at an
8-frame bucket, the same weights and the ZNCC chain: every interval in one
batch (batched_intervals=True) and with StreamingInliers' counts fed
through inliers=, against JAX's, rows within the CLI tolerances; within the
port, the batched path's and the inliers= path's rows equal the pipelined
path's. Inlier counts within 1 of JAX's with the same best frame, which
alone sets the intervals: a confidence within 1e-5 of the threshold (fp32
ViT sums in another order) can cross it (test_torch_coupled_video).
correspondences_batch against JAX's: valid patches and surface points
identical, query pixels within 1e-3 (fp32 box arithmetic).
"""
import dataclasses
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from freepose_tpu_torch.geometry.camera import default_video_intrinsics
from freepose_tpu_torch.io.bop_csv import PoseResult, read_results_csv, write_results_csv
from freepose_tpu_torch.io.mesh import TriMesh, load_obj, pad_mesh, save_obj
from freepose_tpu_torch.io.proposals_json import proposal_entry, save_proposals
from freepose_tpu_torch.models.convert import random_cotracker2_params, save_params
from freepose_tpu_torch.models.cotracker2 import COTRACKER2_TEST
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize

N_FRAMES, H, W = 6, 240, 320
MESH = "blobmesh"
SCALE = 0.15
R_DEG, T_ATOL = 0.05, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _blob(seed=0):
    rng = np.random.default_rng(seed)
    n_lat, n_lon = 8, 12
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 1.0 + 0.25 * np.sin(3 * ph) * np.sin(2 * th)
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                   rng.random((len(verts), 3)).astype(np.float32))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from scripts.common import save_params as jax_save_params

    ws = tmp_path_factory.mktemp("torch_smooth")
    (ws / "meshes" / MESH).mkdir(parents=True)
    save_obj(_blob(), ws / "meshes" / MESH / f"{MESH}.obj")
    mesh = load_obj(ws / "meshes" / MESH / f"{MESH}.obj").normalized().scaled(SCALE)
    k = default_video_intrinsics(W, H)
    gt = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
    rng = np.random.default_rng(1)
    rows = []
    for t in range(N_FRAMES):
        gt[t, :3, :3] = Rotation.from_rotvec([0, 0.06 * t, 0.02 * t]).as_matrix()
        gt[t, :3, 3] = [0.01 * t - 0.02, 0.0, 1.0]
        off = Rotation.from_rotvec(rng.normal(size=3) * np.deg2rad(3.0)).as_matrix()
        rows.append(PoseResult(scene_id=0, im_id=t, obj_id=MESH, score=0.5, R=off @ gt[t, :3, :3],
                               t=gt[t, :3, 3] + rng.normal(scale=0.005, size=3), bbox_visib=np.array([0, 0, 10, 10.0]),
                               scale=SCALE))
    write_results_csv(rows, ws / "coarse.csv", t_scale=1.0)
    v, c, f, valid = (torch.as_tensor(a) for a in pad_mesh(mesh, 512, 1024))
    rgb, _ = rasterize(v, c, f, valid, torch.as_tensor(gt), k, RasterSettings(resolution=320, tile=32))
    (ws / "frames").mkdir()
    background = rng.uniform(0, 255, (H, W, 3))  # a static textured scene
    for t in range(N_FRAMES):
        img = np.where((rgb[t, :H, :W].numpy().sum(-1) > 0)[..., None], rgb[t, :H, :W].numpy() * 255, background)
        img = img + rng.uniform(-20, 20, img.shape)  # sensor noise: no patch is flat
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(ws / "frames" / f"{t:06d}.png")

    params = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    jax_save_params(jax.tree_util.tree_map(np.array, params), ws / "dinov2.npz")
    save_params(random_cotracker2_params(COTRACKER2_TEST, seed=0), ws / "cotracker2.npz")
    cfg = dataclasses.asdict(COTRACKER2_TEST)
    cfg["precision"] = "highest"  # the JAX model's fp32 products; the port always runs them in fp32
    (ws / "cotracker2_test.json").write_text(json.dumps(cfg))
    return ws


@pytest.fixture
def tiny_env(monkeypatch):
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    return monkeypatch


def _argv(ws, out, *extra):
    return ["--video-dir", str(ws / "frames"), "--poses", str(ws / "coarse.csv"), "--mesh-dir", str(ws / "meshes"),
            "--out", str(out), "--weights", str(ws / "dinov2.npz"), "--interval", "3", *extra]


COTRACKER = ("--tracker", "cotracker2", "--tracker-config", "{ws}/cotracker2_test.json",
             "--tracker-weights", "{ws}/cotracker2.npz")
STATIC_CAP = ("--cap", "512", "--cap-buckets", "512")


def _run_jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    importlib.import_module(f"scripts.{name}").main()


def _run_port(name, argv):
    importlib.import_module(f"freepose_tpu_torch.scripts.{name}").main(argv)


def _port_csv(ws, name, *extra):
    """The port CLI's CSV for these flags, run once per workspace."""
    out = ws / f"{name}.csv"
    if not out.exists():
        _run_port("smooth_poses_video", _argv(ws, out, *extra, "--device", "cpu"))
    return read_results_csv(out, t_scale=1.0)


def _geodesic_deg(a, b):
    cos = (np.trace(a @ b.T) - 1.0) / 2.0
    return float(np.rad2deg(np.arccos(np.clip(cos, -1.0, 1.0))))


def _assert_rows_match(ours, ref, r_deg=R_DEG, t_atol=T_ATOL):
    assert [(r.im_id, str(r.obj_id)) for r in ours] == [(r.im_id, str(r.obj_id)) for r in ref]
    assert len(ours) == N_FRAMES
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.R @ o.R.T, np.eye(3), atol=1e-5)
        assert np.isfinite(o.t).all() and o.t[2] > 0
        assert _geodesic_deg(o.R, r.R) <= r_deg, (o.im_id, _geodesic_deg(o.R, r.R))
        np.testing.assert_allclose(o.t, r.t, atol=t_atol)


@pytest.mark.parametrize("tracker", ["zncc", "cotracker2"])
@pytest.mark.parametrize("mode", ["pipelined", "exact"])
def test_cli_matches_jax(workspace, tiny_env, tracker, mode):
    ws = workspace
    extra = [*STATIC_CAP, *(["--exact-intervals"] if mode == "exact" else [])]
    if tracker == "cotracker2":
        extra += [a.format(ws=ws) for a in COTRACKER]
    _run_jax("smooth_poses_video", _argv(ws, ws / f"jax_{tracker}_{mode}.csv", *extra), tiny_env)
    ours = _port_csv(ws, f"torch_{tracker}_{mode}", *extra)
    ref = read_results_csv(ws / f"jax_{tracker}_{mode}.csv", t_scale=1.0)
    _assert_rows_match(ours, ref)
    # The refine moved the coarse rotations (it is not the identity).
    coarse = read_results_csv(ws / "coarse.csv", t_scale=1.0)
    assert max(_geodesic_deg(o.R, c.R) for o, c in zip(ours, coarse)) > 0.1


def test_cotracker2_keeps_a_static_cap_with_the_default_buckets(workspace, tiny_env):
    """CoTracker2's points attend to each other, so the port ignores
    --cap-buckets for it: the default buckets give the static cap's CSV."""
    ws = workspace
    ct2 = [a.format(ws=ws) for a in COTRACKER]
    static = _port_csv(ws, "torch_cotracker2_pipelined", *STATIC_CAP, *ct2)
    default = _port_csv(ws, "torch_cotracker2_default", *ct2)
    for a, b in zip(static, default):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)


def test_cap_above_512_is_the_largest_bucket(workspace, monkeypatch):
    from freepose_tpu_torch.scripts import smooth_poses_video as cli

    assert cli.cap_set(600, [128, 256, 512]) == (128, 256, 512, 600)
    assert cli.cap_set(256, [128, 256, 512]) == (128, 256)
    assert cli.cap_set(512, [512]) == (512,)
    # Through the CLI: every interval with more valid points than the
    # largest default bucket below --cap gets --cap.
    seen = []
    real = cli.smooth_track

    def spy(*args, **kwargs):
        tel = {}
        out = real(*args, **kwargs, telemetry=tel)
        seen.extend(tel["cap_choices"])
        return out

    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.setattr(cli, "smooth_track", spy)
    cli.main(_argv(workspace, workspace / "cap600.csv", "--cap", "600", "--cap-buckets", "128", "--device", "cpu"))
    assert seen and {c for _, c in seen} <= {128, 600} and 600 in {c for _, c in seen}


def test_filter_predictions_matches_jax(workspace, tiny_env):
    ws = workspace
    rng = np.random.default_rng(2)
    props, gt = [], []
    for t in range(N_FRAMES):
        x, y = 60 + 4 * t, 50 + 2 * t
        gt.append([x, y, 80, 70])
        for track, (dx, dy, mesh) in enumerate(((3, -2, "a"), (90, 40, "b"))):
            box = np.array([x + dx, y + dy, x + dx + 80, y + dy + 70], np.float32) + rng.normal(size=4)
            mask = np.zeros((H, W), bool)
            mask[int(box[1]):int(box[3]), int(box[0]):int(box[2])] = True
            entry = proposal_entry(box, mask, mesh, 0.9, 0, t)
            entry["track_id"] = track
            props.append(entry)
    save_proposals(props, ws / "two_tracks.json")
    np.save(ws / "video_gt.npy", {"bboxes": np.asarray(gt, np.float32)}, allow_pickle=True)
    argv = ["--proposals", str(ws / "two_tracks.json"), "--gt", str(ws / "video_gt.npy")]
    _run_jax("filter_predictions", [*argv, "--out", str(ws / "kept_jax.json")], tiny_env)
    _run_port("filter_predictions", [*argv, "--out", str(ws / "kept_torch.json")])
    ours = json.loads((ws / "kept_torch.json").read_text())
    assert ours == json.loads((ws / "kept_jax.json").read_text())
    assert len(ours) == N_FRAMES and {p["track_id"] for p in ours} == {0}


# ------------------------------------------------------------- smooth_track

@pytest.fixture(scope="module")
def smooth_pair(workspace):
    """(port refiner, JAX refiner, port mesh, JAX mesh, frames, poses), the
    CLIs' refiners on the workspace's weights (VIT_TEST, ZNCC)."""
    import os

    from freepose_tpu.io.mesh import load_obj as jax_load_obj
    from freepose_tpu.models.cotracker import COTRACKER_TEST
    from freepose_tpu.models.cotracker import PointTracker as JaxPointTracker
    from freepose_tpu.pipeline.tracking_refiner import TrackingRefiner as JaxRefiner
    from freepose_tpu_torch.datasets.video import load_frame_dir
    from freepose_tpu_torch.models.cotracker import PointTracker
    from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner
    from freepose_tpu_torch.scripts.common import load_dino_extractor
    from scripts.common import load_dino_extractor as jax_load_dino_extractor

    ws = workspace
    old = os.environ.get("FREEPOSE_TINY_MODELS")
    os.environ["FREEPOSE_TINY_MODELS"] = "1"
    try:
        fe = load_dino_extractor(str(ws / "dinov2.npz"), model="vitb", device="cpu")
        jfe = jax_load_dino_extractor(str(ws / "dinov2.npz"), model="vitb")
    finally:
        if old is None:
            del os.environ["FREEPOSE_TINY_MODELS"]
        else:
            os.environ["FREEPOSE_TINY_MODELS"] = old
    ours = TrackingRefiner(feature_fn=lambda im: fe(im, layer=None, feature_type="patch"),
                           tracker=PointTracker(device="cpu"), device="cpu")
    ref = JaxRefiner(feature_fn=lambda im: jfe(im, layer=None, feature_type="patch"),
                     tracker=JaxPointTracker(COTRACKER_TEST), extractor=jfe, feature_layer=None)
    path = ws / "meshes" / MESH / f"{MESH}.obj"
    coarse = sorted(read_results_csv(ws / "coarse.csv", t_scale=1.0), key=lambda r: r.im_id)
    poses = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in coarse]).astype(np.float32)
    return (ours, ref, load_obj(path).normalized().scaled(SCALE), jax_load_obj(path).normalized().scaled(SCALE),
            load_frame_dir(ws / "frames"), poses)


def _assert_inliers_match(ours, ref):
    assert np.abs(np.asarray(ours) - np.asarray(ref)).max() <= 1
    assert int(np.argmax(ours)) == int(np.argmax(ref))


def _assert_poses_match(ours, ref, r_deg=R_DEG, t_atol=T_ATOL):
    assert ours.shape == ref.shape == (N_FRAMES, 4, 4)
    for o, r in zip(ours, ref):
        assert _geodesic_deg(o[:3, :3], r[:3, :3]) <= r_deg
        np.testing.assert_allclose(o[:3, 3], r[:3, 3], atol=t_atol)


def test_smooth_track_batched_intervals_matches_jax(smooth_pair):
    from freepose_tpu.datasets.video import stage_frames_hbm as jax_stage
    from freepose_tpu_torch.datasets.video import stage_frames_hbm
    from freepose_tpu_torch.scripts.smooth_poses_video import smooth_track
    from scripts.smooth_poses_video import smooth_track as jax_smooth_track

    ours, ref, mesh, jmesh, frames, poses = smooth_pair
    staged = stage_frames_hbm(frames, bucket=8, device="cpu")
    k = default_video_intrinsics(W, H)
    batched, inl = smooth_track(ours, mesh, staged, k, poses, interval=3, batched_intervals=True)
    pipelined, inl_p = smooth_track(ours, mesh, staged, k, poses, interval=3)
    jbatched, jinl = jax_smooth_track(ref, jmesh, jax_stage(frames, bucket=8), jnp.asarray(k.numpy()), poses,
                                      interval=3, batched_intervals=True)
    np.testing.assert_array_equal(inl, inl_p)
    _assert_inliers_match(inl, jinl)
    np.testing.assert_allclose(batched, pipelined, atol=1e-5)
    _assert_poses_match(batched, np.asarray(jbatched))
    # The refine moved the coarse rotations (it is not the identity).
    assert max(_geodesic_deg(b[:3, :3], p[:3, :3]) for b, p in zip(batched, poses)) > 0.1
    with pytest.raises(ValueError, match="staged"):
        smooth_track(ours, mesh, frames, k, poses, interval=3, batched_intervals=True)


def test_smooth_track_with_streaming_inliers_matches_jax(smooth_pair):
    """StreamingInliers' counts through inliers=: both packages' counts
    agree, the port's rows equal those of the path that computes the counts
    itself, and JAX's rows fed JAX's counts."""
    from freepose_tpu.datasets.video import stage_frames_hbm as jax_stage
    from freepose_tpu.pipeline.tracking_refiner import StreamingInliers as JaxStreamingInliers
    from freepose_tpu_torch.datasets.video import stage_frames_hbm
    from freepose_tpu_torch.pipeline.tracking_refiner import StreamingInliers
    from freepose_tpu_torch.scripts.smooth_poses_video import smooth_track
    from scripts.smooth_poses_video import smooth_track as jax_smooth_track

    ours, ref, mesh, jmesh, frames, poses = smooth_pair
    staged, jstaged = stage_frames_hbm(frames, bucket=8, device="cpu"), jax_stage(frames, bucket=8)
    k = default_video_intrinsics(W, H)
    jk = jnp.asarray(k.numpy())
    stream, jstream = StreamingInliers(ours, mesh, staged, k, chunk=4), JaxStreamingInliers(ref, jmesh, jstaged, jk,
                                                                                             chunk=4)
    for t in (3, 0, 5, 1, 4, 2):
        stream.add(t, poses[t])
        jstream.add(t, poses[t])
    counts, jcounts = stream.finalize()[0], jstream.finalize()[0]
    _assert_inliers_match(counts, jcounts)
    fed, fed_inl = smooth_track(ours, mesh, staged, k, poses, interval=3, inliers=counts)
    computed, computed_inl = smooth_track(ours, mesh, staged, k, poses, interval=3)
    np.testing.assert_array_equal(fed_inl, counts)
    np.testing.assert_array_equal(computed_inl, counts)
    np.testing.assert_array_equal(fed, computed)
    jfed, _ = jax_smooth_track(ref, jmesh, jstaged, jk, poses, interval=3, inliers=jcounts)
    _assert_poses_match(fed, np.asarray(jfed))
    with pytest.raises(ValueError, match="inliers length"):
        smooth_track(ours, mesh, staged, k, poses, interval=3, inliers=counts[:-1])
    from freepose_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="device_mesh requires a device-staged video"):
        smooth_track(ours, mesh, frames, k, poses, interval=3, device_mesh=make_mesh(devices=["cpu"] * 2))


def test_correspondences_batch_matches_jax(smooth_pair):
    ours, ref, mesh, jmesh, _, poses = smooth_pair
    k = default_video_intrinsics(W, H)
    q, s, v = (x.numpy() for x in ours.correspondences_batch(mesh, k, poses[:3]))
    rq, rs, rv = (np.asarray(x) for x in ref.correspondences_batch(jmesh, jnp.asarray(k.numpy()),
                                                                     jnp.asarray(poses[:3])))
    assert q.shape == (3, 37 * 37, 2) and s.shape == (3, 37 * 37, 3) and v.shape == (3, 37 * 37)
    np.testing.assert_array_equal(v, rv)
    assert (v.sum(axis=1) > 20).all()
    np.testing.assert_array_equal(s[v], rs[v])
    np.testing.assert_allclose(q, rq, atol=1e-3)
    for i in range(3):  # each start as the single-pose correspondences
        one = ours.compute_2d3d_correspondences(mesh, None, k, poses[i])
        for a, b in zip(one, (q[i], s[i], v[i])):
            np.testing.assert_array_equal(a, b)
