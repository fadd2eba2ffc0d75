"""The track refiner of the PyTorch port vs the JAX package's, on the CPU:
the plain rasterizer at 518² with tile 37 (the JAX side its XLA path), a
192-face mesh, a tiny DINOv2 (hidden 32, 2 layers, 2 heads) with the JAX
init's weights in both, the ZNCC tracker.

Tolerances: the quantile threshold and the patch binning's winners are
identical (ties planted: duplicate samples and equal depths in one patch);
correspondences: the same valid patches and surface points, query pixels
within 1e-3; confidences within 1e-5 (fp32 ViT sums in another order) with
identical render masks, and the same inlier counts; EPnP poses within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from freepose_tpu.io.mesh import TriMesh as JaxTriMesh
from freepose_tpu.models.dinov2 import DinoFeatureExtractor as JaxExtractor
from freepose_tpu.models.dinov2 import DinoV2Config as JaxDinoConfig
from freepose_tpu.ops.rasterizer import RasterSettings as JaxRasterSettings
from freepose_tpu.pipeline import tracking_refiner as jtr
from freepose_tpu_torch.io.mesh import TriMesh, pad_mesh
from freepose_tpu_torch.models.cotracker import PointTracker
from freepose_tpu_torch.models.dinov2 import DinoFeatureExtractor, DinoV2Config
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize
from freepose_tpu_torch.pipeline import tracking_refiner as tr

RES = 518
K = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]], np.float32)
FACES_PER_TILE = 128


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mesh_arrays(seed=0, n_lat=8, n_lon=12):
    rng = np.random.default_rng(seed)
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
    return (np.asarray(verts, np.float32) * 0.1, np.asarray(faces, np.int32),
            rng.random((len(verts), 3)).astype(np.float32))


def _gt_poses(t):
    poses = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
    for i in range(t):
        poses[i, :3, :3] = Rot.from_rotvec([0, 0.08 * i, 0.02 * i]).as_matrix()
        poses[i, :3, 3] = [0.02 * i, 0.0, 0.8]
    return poses


def _frames(mesh, poses):
    v, c, f, valid = (torch.as_tensor(a) for a in pad_mesh(mesh, 512, 1024))
    rgb, _ = rasterize(v, c, f, valid, torch.as_tensor(poses), torch.as_tensor(K),
                       RasterSettings(resolution=320, tile=32, max_faces_per_tile=256))
    return (rgb[:, :240, :320].numpy() * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    """(port refiner, JAX refiner, port mesh, JAX mesh) on the same weights."""
    jcfg = JaxDinoConfig(hidden_size=32, num_layers=2, num_heads=2, patch_size=14, image_size=56)
    jfe = JaxExtractor(jcfg)
    fe = DinoFeatureExtractor(DinoV2Config(hidden_size=32, num_layers=2, num_heads=2, image_size=56),
                              params=jax.tree.map(np.asarray, jfe.params), device="cpu")
    ours = tr.TrackingRefiner(feature_fn=lambda im: fe(im, layer=None, feature_type="patch"),
                              tracker=PointTracker(device="cpu"), max_vertices=512, max_faces=1024,
                              n_surface_samples=2000, device="cpu",
                              settings=RasterSettings(resolution=RES, tile=37, max_faces_per_tile=FACES_PER_TILE))
    ref = jtr.TrackingRefiner(feature_fn=lambda im: jfe(im, layer=None, feature_type="patch"),
                              tracker=None, max_vertices=512,
                              max_faces=1024, n_surface_samples=2000,
                              settings=JaxRasterSettings(resolution=RES, tile=37, max_faces_per_tile=FACES_PER_TILE))
    v, f, c = _mesh_arrays()
    return ours, ref, TriMesh(v, f, c), JaxTriMesh(v, f, c)


def test_quantile_threshold_matches_jax():
    rng = np.random.default_rng(0)
    for n_pos in (0, 1, 4, 5, 37, 1369, 4107, 9999):
        conf = np.concatenate([rng.uniform(0.01, 1.0, n_pos), -rng.random(50), np.zeros(20)]).astype(np.float32)
        conf = rng.permutation(conf)
        ours = float(tr.quantile_threshold(torch.as_tensor(conf)))
        assert ours == float(jtr.quantile_threshold(jnp.asarray(conf))), n_pos
    ties = np.repeat(np.float32([0.3, 0.7]), 40)
    assert float(tr.quantile_threshold(torch.as_tensor(ties))) == float(jtr.quantile_threshold(jnp.asarray(ties)))


def test_bin_surface_to_patches_with_planted_ties_matches_jax():
    """Samples on a plane at one depth (equal keys within a centre bin),
    duplicated samples (equal keys everywhere): the winners are the lowest
    sample index in both packages."""
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-0.15, 0.15, (300, 2)), np.full((300, 1), 0.0)], axis=1)
    pts = np.concatenate([pts, pts[:150], rng.uniform(-0.15, 0.15, (200, 3))]).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.6
    new_k = np.array([[600.0, 0, 259.0], [0, 600.0, 259.0], [0, 0, 1]], np.float32)
    mask37 = rng.random((37, 37)) > 0.2
    bbox = np.array([10.0, 20.0, 330.0, 340.0], np.float32)
    ours = tr._bin_surface_to_patches(*(torch.as_tensor(a) for a in (pts, pose, new_k, mask37, bbox)))
    ref = jtr._bin_surface_to_patches(*(jnp.asarray(a) for a in (pts, pose, new_k, mask37, bbox)))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ours[2].sum()) > 100


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "mask"])
def test_correspondences_match_jax(pair, with_mask):
    ours, ref, mesh, jmesh = pair
    pose = _gt_poses(2)[1]
    mask = None
    if with_mask:  # the object's left half
        mask = np.zeros((240, 320), np.float32)
        mask[:, :150] = 1.0
    photo = np.zeros((3, 240, 320), np.float32)
    q, s, v = ours.compute_2d3d_correspondences(mesh, photo, K, pose, mask=mask)
    rq, rs, rv = ref.compute_2d3d_correspondences(jmesh, jnp.asarray(photo), jnp.asarray(K), jnp.asarray(pose),
                                                  mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(v, rv)
    assert 20 < v.sum() < 37 * 37
    np.testing.assert_array_equal(s[v], np.asarray(rs)[v])
    np.testing.assert_allclose(q, rq, atol=1e-3)


def test_confidence_and_inliers_with_a_ragged_chunk_match_jax(pair):
    ours, ref, mesh, jmesh = pair
    poses = _gt_poses(6)
    poses[4, :3, :3] = Rot.from_rotvec([0, 1.5, 0]).as_matrix()  # one wrong pose
    frames = _frames(mesh, _gt_poses(6)).transpose(0, 3, 1, 2)
    conf = ours.pose_confidence_batch(mesh, frames[:2], K, poses[:2])
    conf_ref = ref.pose_confidence_batch(jmesh, jnp.asarray(frames[:2]), jnp.asarray(K), jnp.asarray(poses[:2]))
    np.testing.assert_array_equal(conf != 0, conf_ref != 0)
    np.testing.assert_allclose(conf, conf_ref, atol=1e-5)
    one = ours.pose_confidence(mesh, frames[1], K, poses[1])
    np.testing.assert_allclose(one, ref.pose_confidence(jmesh, jnp.asarray(frames[1]), jnp.asarray(K),
                                                        jnp.asarray(poses[1])), atol=1e-5)
    np.testing.assert_allclose(one, conf[1], atol=1e-5)
    # Chunks of 4: the second holds frames 4 and 5 and repeats frame 5.
    inl, thr = ours.n_inliers_per_pose(mesh, frames, K, poses, chunk=4)
    inl_ref, thr_ref = ref.n_inliers_per_pose(jmesh, frames, jnp.asarray(K), poses, chunk=4)
    np.testing.assert_allclose(thr, thr_ref, atol=1e-6)
    np.testing.assert_array_equal(inl, inl_ref)
    assert inl.shape == (6,) and int(np.argmin(inl)) == 4


def test_pnp_batch_and_query_frames_match_jax(pair):
    ours, ref, mesh, jmesh = pair
    rng = np.random.default_rng(2)
    world = rng.uniform(-0.1, 0.1, (60, 3)).astype(np.float32)
    poses = _gt_poses(3)
    uv = np.stack([(world @ p[:3, :3].T + p[:3, 3]) @ K.T for p in poses])
    uv = (uv[..., :2] / uv[..., 2:] + rng.normal(scale=0.5, size=(3, 60, 2))).astype(np.float32)
    valid = rng.random((3, 60)) > 0.3
    out = ours.compute_pnp_batch(uv, world, valid, K)
    np.testing.assert_allclose(out, np.asarray(ref.compute_pnp_batch(uv, world, valid, K)), atol=2e-5)
    np.testing.assert_allclose(ours.compute_pnp(uv[1], world, valid[1], K), out[1], atol=1e-6)
    inliers = np.array([1, 9, 8, 1, 1, 1, 10, 1, 1, 7, 1, 1])
    for n_ref in (1, 3, 8):
        np.testing.assert_array_equal(tr.TrackingRefiner.get_query_frames(inliers, n_ref),
                                      jtr.TrackingRefiner.get_query_frames(inliers, n_ref))


def test_compute_pnp_or_need_resample_matches_jax(pair):
    """Tracks that sit on the correspondences of the true pose: no resample,
    and the pose comes back; with most points invisible, a resample."""
    ours, ref, mesh, jmesh = pair
    pose = _gt_poses(2)[1]
    q, s, v = ours.compute_2d3d_correspondences(mesh, None, K, pose)
    tracks = q + np.random.default_rng(3).normal(scale=0.3, size=q.shape).astype(np.float32)
    for vis in (np.ones_like(v), np.arange(len(v)) % 4 == 0):
        need, p_ours = ours.compute_pnp_or_need_resample(mesh, None, tracks, vis, s, v, K)
        need_ref, p_ref = ref.compute_pnp_or_need_resample(jmesh, None, tracks, vis, s, v, jnp.asarray(K))
        assert need == need_ref
        if p_ref is None:
            assert p_ours is None
        else:
            np.testing.assert_allclose(p_ours, p_ref, atol=2e-5)


def test_sharded_and_mesh_paths_name_slice_g(pair):
    """The mesh paths' refusals, as JAX's: no extractor, a batch that does
    not divide over the axis (tests/test_torch_sharded_smooth.py holds
    their results against JAX's)."""
    from freepose_tpu_torch.parallel.mesh import make_mesh

    ours, _, mesh, _ = pair
    mesh2 = make_mesh(data=2, devices=["cpu"] * 2)
    frames = np.zeros((3, 3, 8, 8), np.uint8)
    with pytest.raises(ValueError, match="requires `extractor`"):
        ours.pose_confidence_batch_sharded(mesh, frames, K, _gt_poses(3), device_mesh=mesh2)
    with pytest.raises(ValueError, match="must divide over the 'data' axis"):
        ours.correspondences_batch(mesh, K, _gt_poses(3), device_mesh=mesh2)
    with pytest.raises(ValueError, match="requires `extractor`"):
        ours.n_inliers_per_pose(mesh, frames, K, _gt_poses(3), device_mesh=mesh2)
