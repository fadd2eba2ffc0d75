"""The sharded track refine in both packages, on the CPU.

JAX's shard_map versions run on a (4, 2) mesh of conftest's 8 virtual CPU
devices, split over "data"; the port's on make_mesh(4, 2) over the one
`cpu` device repeated, so each of the 4 "data" shards works through its
block in turn. The scene is test_torch_smooth_slice's workspace: a blob
mesh, 6 noisy 240x320 frames, a coarse CSV, VIT_TEST weights in the JAX
layout (dinov2_from_jax) as the extractor of both refiners, the ZNCC
tracker.

Tolerances: confidence maps within 1e-5 (fp32 ViT sums in another order)
and identical render coverage; correspondences: valid patches and surface
points identical, query pixels within 1e-3 (fp32 box arithmetic);
ZNCC tracks within 1e-3 px and scores within 1e-5; smooth_track rows
within 1e-4 of the port's unsharded pipelined and batched paths and of
JAX's sharded pass, inlier counts within 1 of JAX's with the same best
frame.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from freepose_tpu_torch.geometry.camera import default_video_intrinsics
from freepose_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_smooth_slice import H, MESH, SCALE, W, _assert_inliers_match, workspace  # noqa: F401

POSE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(data=4, model=2), make_mesh(data=4, model=2, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def sharded_pair(workspace):  # noqa: F811
    """(port refiner, JAX refiner, port mesh, JAX mesh, frames, poses), each
    refiner with its extractor (VIT_TEST to its last layer)."""
    from freepose_tpu.io.mesh import load_obj as jax_load_obj
    from freepose_tpu.models.cotracker import COTRACKER_TEST
    from freepose_tpu.models.cotracker import PointTracker as JaxPointTracker
    from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
    from freepose_tpu.models.dinov2 import DinoFeatureExtractor as JaxExtractor
    from freepose_tpu.pipeline.tracking_refiner import TrackingRefiner as JaxRefiner
    from freepose_tpu_torch.datasets.video import load_frame_dir
    from freepose_tpu_torch.io.bop_csv import read_results_csv
    from freepose_tpu_torch.io.mesh import load_obj
    from freepose_tpu_torch.models.cotracker import PointTracker
    from freepose_tpu_torch.models.dinov2 import VIT_TEST, DinoFeatureExtractor
    from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner
    from scripts.common import load_params

    ws = workspace
    params = load_params(str(ws / "dinov2.npz"))
    fe = DinoFeatureExtractor(VIT_TEST, params=params, device="cpu")
    jfe = JaxExtractor(JAX_VIT_TEST, params=params)
    ours = TrackingRefiner(feature_fn=lambda im: fe(im, layer=None, feature_type="patch"),
                           tracker=PointTracker(device="cpu"), device="cpu", extractor=fe, feature_layer=None)
    ref = JaxRefiner(feature_fn=lambda im: jfe(im, layer=None, feature_type="patch"),
                     tracker=JaxPointTracker(COTRACKER_TEST), extractor=jfe, feature_layer=None)
    path = ws / "meshes" / MESH / f"{MESH}.obj"
    coarse = sorted(read_results_csv(ws / "coarse.csv", t_scale=1.0), key=lambda r: r.im_id)
    poses = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in coarse]).astype(np.float32)
    return (ours, ref, load_obj(path).normalized().scaled(SCALE), jax_load_obj(path).normalized().scaled(SCALE),
            load_frame_dir(ws / "frames"), poses)


def test_pose_confidence_batch_sharded_matches_jax(sharded_pair, meshes):
    ours, ref, mesh, jmesh, frames, poses = sharded_pair
    jm, pm = meshes
    k = default_video_intrinsics(W, H)
    chw = frames[:4].transpose(0, 3, 1, 2)
    got = ours.pose_confidence_batch_sharded(mesh, chw, k, poses[:4], pm)
    theirs = ref.pose_confidence_batch_sharded(jmesh, jnp.asarray(chw), jnp.asarray(k.numpy()),
                                               jnp.asarray(poses[:4]), jm)
    single = ours.pose_confidence_batch(mesh, chw, k, poses[:4])
    assert got.shape == (4, 37, 37)
    np.testing.assert_array_equal(got != 0, single != 0)
    np.testing.assert_allclose(got, np.asarray(theirs), atol=1e-5)
    np.testing.assert_allclose(got, single, atol=1e-5)
    with pytest.raises(ValueError, match="must divide over the 'data' axis"):
        ours.pose_confidence_batch_sharded(mesh, chw[:3], k, poses[:3], pm)
    with pytest.raises(ValueError, match="requires `extractor`"):
        dataclasses.replace(ours, extractor=None).pose_confidence_batch_sharded(mesh, chw, k, poses[:4], pm)


def test_correspondences_batch_sharded_matches_jax(sharded_pair, meshes):
    ours, ref, mesh, jmesh, _, poses = sharded_pair
    jm, pm = meshes
    k = default_video_intrinsics(W, H)
    q, s, v = (x.numpy() for x in ours.correspondences_batch(mesh, k, poses[:4], device_mesh=pm, axis="data"))
    jq, js, jv = (np.asarray(x) for x in ref.correspondences_batch(jmesh, jnp.asarray(k.numpy()),
                                                                   jnp.asarray(poses[:4]), device_mesh=jm,
                                                                   axis="data"))
    q1, s1, v1 = (x.numpy() for x in ours.correspondences_batch(mesh, k, poses[:4]))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(s[v], js[jv])
    np.testing.assert_allclose(q, jq, atol=1e-3)
    for a, b in ((q, q1), (s, s1), (v, v1)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="must divide over the 'data' axis"):
        ours.correspondences_batch(mesh, k, poses[:3], device_mesh=pm)


def test_track_device_batch_sharded_matches_jax(sharded_pair, meshes):
    from freepose_tpu.models.cotracker import COTRACKER_TEST
    from freepose_tpu.models.cotracker import PointTracker as JaxPointTracker

    ours, _, _, _, frames, _ = sharded_pair
    jm, pm = meshes
    videos = np.stack([frames[i:i + 3] for i in range(4)])  # 4 intervals of 3 frames
    rng = np.random.default_rng(0)
    queries = np.stack([rng.uniform([40, 40], [280, 200], (5, 2)) for _ in range(4)]).astype(np.float32)
    tracks, scores = ours.tracker.track_device_batch(torch.as_tensor(videos), queries, device_mesh=pm)
    jt, js = JaxPointTracker(COTRACKER_TEST).track_device_batch(jnp.asarray(videos), jnp.asarray(queries),
                                                                device_mesh=jm, axis="data")
    t1, s1 = ours.tracker.track_device_batch(torch.as_tensor(videos), queries)
    np.testing.assert_array_equal(tracks.numpy(), t1.numpy())
    np.testing.assert_array_equal(scores.numpy(), s1.numpy())
    np.testing.assert_allclose(tracks.numpy(), np.asarray(jt), atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-5)
    with pytest.raises(ValueError, match="must divide over the 'data' axis"):
        ours.tracker.track_device_batch(torch.as_tensor(videos[:3]), queries[:3], device_mesh=pm)


def test_smooth_track_sharded_matches_jax_and_single(sharded_pair, meshes):
    """The sharded pass (confidence chunks and one batch of intervals over
    "data") against the port's unsharded pipelined and batched paths and
    JAX's sharded pass."""
    from freepose_tpu.datasets.video import stage_frames_hbm as jax_stage
    from freepose_tpu_torch.datasets.video import stage_frames_hbm
    from freepose_tpu_torch.scripts.smooth_poses_video import smooth_track
    from scripts.smooth_poses_video import smooth_track as jax_smooth_track

    ours, ref, mesh, jmesh, frames, poses = sharded_pair
    jm, pm = meshes
    staged = stage_frames_hbm(frames, bucket=8, device="cpu")
    k = default_video_intrinsics(W, H)
    shard, inl = smooth_track(ours, mesh, staged, k, poses, interval=3, device_mesh=pm)
    single, inl_s = smooth_track(ours, mesh, staged, k, poses, interval=3)
    batched, inl_b = smooth_track(ours, mesh, staged, k, poses, interval=3, batched_intervals=True)
    np.testing.assert_array_equal(inl, inl_s)
    np.testing.assert_array_equal(inl, inl_b)
    np.testing.assert_allclose(shard, single, atol=POSE_ATOL)
    np.testing.assert_allclose(shard, batched, atol=POSE_ATOL)
    jshard, jinl = jax_smooth_track(ref, jmesh, jax_stage(frames, bucket=8), jnp.asarray(k.numpy()), poses,
                                    interval=3, device_mesh=jm, mesh_axis="data")
    _assert_inliers_match(inl, jinl)
    np.testing.assert_allclose(shard, np.asarray(jshard), atol=POSE_ATOL)
    with pytest.raises(ValueError, match="device-staged video"):
        smooth_track(ours, mesh, frames, k, poses, interval=3, device_mesh=pm)
