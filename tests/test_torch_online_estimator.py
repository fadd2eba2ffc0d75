"""The online refine's building blocks in both packages, on the CPU.

Same inputs through the JAX functions (under jax.jit, with the XLA
rasterizer) and the port's (fp32, plain rasterizer): the JAX VIT_TEST
DINOv2 weights carried over by dinov2_from_jax, a coloured blob mesh,
84² renders of a 200-pose fine grid. The port is handed the JAX package's
pose grid, so both rasterize the same poses.

Tolerances: neighbourhood indices, masks and render masks identical; zoomed
intrinsics identical; geodesic distances within 0.05° (JAX works in float32,
whose trace rounding moves an angle near 0 by up to ~0.03°; the port in
float64); scores and lifted poses within 1e-5 (fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.geometry.rotation import geodesic_distance as jax_geodesic
from freepose_tpu.geometry.rotation import template_poses as jax_template_poses
from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
from freepose_tpu.models.dinov2 import DinoFeatureExtractor as JaxExtractor
from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from freepose_tpu.ops.rasterizer import RasterSettings as JaxSettings
from freepose_tpu.pipeline import fine_cache as jfc
from freepose_tpu.pipeline import online_pose_estimator as jope
from freepose_tpu.pipeline.renderer import TemplateRenderer as JaxRenderer
from freepose_tpu.pipeline.renderer import zoom_intrinsics_for_poses as jax_zoom
from freepose_tpu.pipeline.template_bank import TemplateBank as JaxBank
from freepose_tpu.pipeline.template_bank import depth_stats_per_k as jax_depth_stats_per_k
from freepose_tpu_torch.geometry.rotation import geodesic_distance
from freepose_tpu_torch.io.mesh import TriMesh
from freepose_tpu_torch.models.dinov2 import VIT_TEST, DinoFeatureExtractor
from freepose_tpu_torch.ops.rasterizer import RasterSettings
from freepose_tpu_torch.pipeline import fine_cache, online_pose_estimator as ope
from freepose_tpu_torch.pipeline.renderer import TemplateRenderer, zoom_intrinsics_for_poses
from freepose_tpu_torch.pipeline.template_bank import TemplateBank, depth_stats_per_k

RES, LAYER, N_FINE = 84, 2, 200


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the suite runs several files
    at once, one per worker, and torch's default of one thread per core in
    each worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def blob(seed=0) -> TriMesh:
    rng = np.random.default_rng(seed)
    n_lat, n_lon = 10, 14
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 1.0 + 0.2 * np.sin(3 * ph) * np.sin(2 * th)
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                   rng.random((len(verts), 3)).astype(np.float32))


def vit_test_params():
    """The JAX model's VIT_TEST parameters, LayerScale well away from 1e-5."""
    p = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    p = jax.tree_util.tree_map(np.array, p)
    rng = np.random.default_rng(1)
    for name in ("ls1", "ls2"):
        g = p["blocks"]["block"][name]["gamma"]
        p["blocks"]["block"][name]["gamma"] = rng.uniform(0.2, 0.6, g.shape).astype(np.float32)
    return p


class Pair:
    """One scene in both packages: extractors, renderers, banks, and
    estimators built on the JAX package's fine grid."""

    def __init__(self, params):
        self.jfe = JaxExtractor(JAX_VIT_TEST, params=params)
        self.tfe = DinoFeatureExtractor(VIT_TEST, params=params, device="cpu")
        self.jfn = lambda imgs: self.jfe(imgs, layer=LAYER, feature_type="patch")  # noqa: E731
        self.tfn = lambda imgs: self.tfe(imgs, layer=LAYER, feature_type="patch")  # noqa: E731
        kw = dict(n_poses=16, resolution=RES, max_vertices=256, max_faces=512)
        self.jr = JaxRenderer(settings=JaxSettings(resolution=RES, tile=28, max_faces_per_tile=128), **kw)
        self.tr = TemplateRenderer(settings=RasterSettings(resolution=RES, tile=28, max_faces_per_tile=128),
                                   device="cpu", **kw)
        self.jbank = JaxBank(self.jfn, self.jr, cache_size=2)
        self.tbank = TemplateBank(self.tfn, self.tr, cache_size=2)
        self.grid = np.array(jax_template_poses(N_FINE))
        self.mesh = blob()

    def estimators(self, n_neighbors=8, cap=0, extractor=True, zoom=False):
        j = jope.OnlinePoseEstimator(
            self.jfn, self.jbank, self.jr, n_coarse_poses=16, n_fine_poses=N_FINE, n_neighbors=n_neighbors,
            extractor=self.jfe if extractor else None, feature_layer=LAYER, fine_cache_capacity=cap,
            zoom_renders=zoom)
        return j, self.port_estimator(n_neighbors, cap, extractor, zoom)

    def port_estimator(self, n_neighbors=8, cap=0, extractor=True, zoom=False):
        t = ope.OnlinePoseEstimator(
            self.tfn, self.tbank, self.tr, n_coarse_poses=16, n_fine_poses=N_FINE, n_neighbors=n_neighbors,
            extractor=self.tfe if extractor else None, feature_layer=LAYER, fine_cache_capacity=cap,
            zoom_renders=zoom)
        t.fine_poses = torch.as_tensor(self.grid)
        t._fine_rots_np = self.grid[:, :3, :3].copy()
        return t

    def query(self, grid_index: int):
        """The crop, mask and box of the mesh rendered at a grid pose
        (numpy, from the JAX renderer)."""
        rgb, depth = self.jr.render_from_poses(self.mesh, jnp.asarray(self.grid[grid_index])[None])
        props, masks, boxes = self.jr.generate_proposals(rgb, depth)
        return np.asarray(props[0]), np.asarray(masks[0]), np.asarray(boxes[0], np.float32)


@pytest.fixture(scope="module")
def pair():
    return Pair(vit_test_params())


def _rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(q).as_matrix().astype(np.float32)


def test_geodesic_distance_matches_jax():
    rots = _rotations(300, 0)
    for ref in (rots[42], _rotations(1, 1)[0]):
        ours = geodesic_distance(torch.as_tensor(rots), torch.as_tensor(ref)).numpy()
        theirs = np.asarray(jax.jit(jax_geodesic)(jnp.asarray(rots), jnp.asarray(ref)))
        np.testing.assert_allclose(ours, theirs, atol=0.05)
        rad = geodesic_distance(torch.as_tensor(rots), torch.as_tensor(ref), degrees=False).numpy()
        np.testing.assert_allclose(np.degrees(rad), ours, rtol=1e-12)
    assert ours.dtype == np.float64 and 0.0 <= ours.min() and ours.max() <= 180.0


@pytest.mark.parametrize("probe", [3, 777, 1500, "tie"])
def test_select_neighborhood_matches_jax(probe):
    grid = np.array(jax_template_poses(2000))
    if probe == "tie":
        # Every pose twice: each distance is an exact tie, which both break
        # toward the lower index.
        grid = np.concatenate([grid, grid[::-1]])
        probe = 10
    sel_fn = jax.jit(jope.select_neighborhood, static_argnames=("n_neighbors",))
    for deg, n in ((15.0, 32), (40.0, 64)):
        j_sel, j_idx, j_mask = sel_fn(jnp.asarray(grid), jnp.asarray(grid[probe]), deg, n_neighbors=n)
        t_sel, t_idx, t_mask = ope.select_neighborhood(torch.as_tensor(grid), torch.as_tensor(grid[probe]), deg, n)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
        # The host copy selects the same neighbourhood as the device function.
        h_idx, h_mask = fine_cache.select_neighborhood_host(grid[:, :3, :3], grid[probe, :3, :3], deg, n)
        np.testing.assert_array_equal(h_idx, t_idx.numpy())
        np.testing.assert_array_equal(h_mask, t_mask.numpy())
    if len(grid) == 4000:
        assert set(t_idx[:2].tolist()) == {probe, 3999 - probe}


def test_select_neighborhood_host_matches_jax():
    grid = np.asarray(jax_template_poses(2000))
    rots = grid[:, :3, :3]
    center = _rotations(1, 3)[0]
    for probe in (5, 900, 1999):
        assert all(np.array_equal(a, b) for a, b in zip(
            fine_cache.select_neighborhood_host(rots, rots[probe], 15.0, 32),
            jfc.select_neighborhood_host(rots, rots[probe], 15.0, 32)))
        for extra_center in (None, center):
            ours = fine_cache.select_neighborhood_host(rots, rots[probe], 15.0, 32, n_extra=32,
                                                       extra_center=extra_center)
            theirs = jfc.select_neighborhood_host(rots, rots[probe], 15.0, 32, n_extra=32, extra_center=extra_center)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_rescore_views_matches_jax(use_mask, dtype):
    rng = np.random.default_rng(4)
    r, grid, d = 8, 6, 32
    feats = rng.normal(size=(r, grid * grid, d)).astype(np.float32)
    query = rng.normal(size=(grid * grid, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    query /= np.linalg.norm(query, axis=-1, keepdims=True)
    valid = np.array([True, True, False, True, True, True, False, True])
    rmasks = rng.random((r, RES, RES)) < 0.3
    pmask = rng.random((RES, RES)) < 0.4
    jfeats, jquery = (jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32) for x in (feats, query))
    theirs = np.asarray(jope.rescore_views(jfeats, jquery, jnp.asarray(valid), jnp.asarray(rmasks), jnp.asarray(pmask),
                                           grid=grid, use_mask=use_mask))
    tfeats, tquery = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
                      for x in (jfeats, jquery))
    ours = ope.rescore_views(tfeats, tquery, torch.as_tensor(valid), torch.as_tensor(rmasks), torch.as_tensor(pmask),
                             grid, use_mask)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(ours.numpy()), ~valid)
    np.testing.assert_allclose(ours.numpy()[valid], theirs[valid], atol=1e-5)


def test_score_and_lift_from_stats_matches_jax():
    rng = np.random.default_rng(5)
    scores = rng.uniform(0, 0.5, 8).astype(np.float32)
    scores[[2, 5]] = 0.9  # a tie for the best: the lower view wins
    scores[[0, 7]] = -np.inf
    pc_min = rng.uniform(-0.3, -0.1, (8, 3)).astype(np.float32)
    pc_max = rng.uniform(0.1, 0.3, (8, 3)).astype(np.float32)
    pc_mean = rng.uniform(-0.05, 0.05, (8, 3)).astype(np.float32) + np.float32([0, 0, 1.1])
    poses = np.asarray(jax_template_poses(8))
    k = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]], np.float32)
    bbox = np.array([100.0, 80.0, 180.0, 150.0], np.float32)
    args = (scores, pc_min, pc_max, pc_mean, poses, k, bbox, np.float32(0.12))
    jt, js, ji = jope.score_and_lift_from_stats(*map(jnp.asarray, args), rendering_scale=0.25)
    tt, ts, ti = ope.score_and_lift_from_stats(*map(torch.as_tensor, args), rendering_scale=0.25)
    assert int(ti) == int(ji) == 2
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_zoom_intrinsics_match_jax(pair):
    v, c, f, fv = pair.jr._padded(pair.mesh, 0.25)
    poses = np.concatenate([pair.grid[:24], pair.grid[100:108]])
    poses[-1, :3, 3] = [0.0, 0.0, -2.0]  # behind the camera: the unzoomed k
    theirs = np.asarray(jax_zoom(v, f, fv, jnp.asarray(poses), pair.jr.k, RES))
    ours = zoom_intrinsics_for_poses(*(torch.as_tensor(np.asarray(a)) for a in (v, f, fv, poses, pair.jr.k)), RES)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(ours[-1].numpy(), np.asarray(pair.jr.k))


def test_zoom_counts_every_vertex_of_a_valid_face():
    """A spike whose tip is vertex 0, padded with degenerate faces (index 0,
    face_valid False). The port's bbox holds the tip whether or not the
    mesh is padded. The JAX function marks vertices with one scatter of
    face_valid over all corners; on the CPU the padding faces' False lands
    last, so padded, its bbox loses the tip (a fault of the JAX package,
    recorded in ROADMAP queue 3)."""
    v = np.array([[0.0, 0.9, 0.0], [-0.2, -0.2, 0.1], [0.2, -0.2, 0.1], [0.0, -0.1, -0.2]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]], np.int32)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, 2, 3] = 1.5
    k = np.array([[300.0, 0, 42], [0, 300.0, 42], [0, 0, 1]], np.float32)
    pad_f = np.concatenate([f, np.zeros((4, 3), np.int32)])
    pad_fv = np.arange(8) < 4
    ours = [zoom_intrinsics_for_poses(*map(torch.as_tensor, (v, ff, fv, pose, k)), RES).numpy()
            for ff, fv in ((f, np.ones(4, bool)), (pad_f, pad_fv))]
    theirs = [np.asarray(jax_zoom(*map(jnp.asarray, (v, ff, fv, pose, k)), RES))
              for ff, fv in ((f, np.ones(4, bool)), (pad_f, pad_fv))]
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], ours[0])
    assert not np.array_equal(theirs[1], theirs[0])


def test_depth_stats_per_k_matches_jax():
    rng = np.random.default_rng(6)
    depth = np.where(rng.random((5, 40, 40)) < 0.4, rng.uniform(0.8, 1.4, (5, 40, 40)), 0).astype(np.float32)
    depth[3] = 0.0  # an empty view: a zero-extent cloud at the origin
    ks = np.tile(np.array([[200.0, 0, 20], [0, 210.0, 19], [0, 0, 1]], np.float32), (5, 1, 1))
    ks[:, :2] *= rng.uniform(0.5, 2.0, (5, 1, 1)).astype(np.float32)
    ours = depth_stats_per_k(torch.as_tensor(depth), torch.as_tensor(ks))
    theirs = jax_depth_stats_per_k(jnp.asarray(depth), jnp.asarray(ks))
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=1e-5)


@pytest.mark.parametrize("zoom", [False, True])
def test_render_view_block_matches_jax(pair, zoom):
    poses = pair.grid[[3, 40, 41, 150, 199]]
    jv = pair.jr._padded(pair.mesh, 0.25)
    block = jax.jit(jope.render_view_block, static_argnames=("settings", "pose_chunk", "resolution", "zoom"))
    jp, jm, js = block(*jv, jnp.asarray(poses), pair.jr.k, settings=pair.jr.settings, pose_chunk=4,
                       resolution=RES, zoom=zoom)
    tp, tm, ts = ope.render_view_block(*pair.tr._padded(pair.mesh, 0.25), torch.as_tensor(poses), pair.tr.k,
                                       pair.tr.settings, 4, RES, zoom)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.any(dim=(1, 2)).all()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    for o, t in zip(ts, js):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=1e-5)


@pytest.mark.parametrize("extractor", [True, False], ids=["extractor", "feature_fn"])
def test_refine_matches_jax(pair, extractor):
    """Uncached refine over a short track: the neighbourhood of each
    previous grid pose, the crop of the mesh at a nearby grid pose."""
    jest, test = pair.estimators(n_neighbors=8, extractor=extractor)
    for t, (prev, seen) in enumerate(((7, 8), (8, 8), (60, 61), (150, 7))):
        prop, mask, box = pair.query(seen)
        jq = jest.coarse.query_features(jnp.asarray(prop))
        tq = test.coarse.query_features(torch.as_tensor(prop))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
        kw = dict(neighborhood_deg=40.0, mask_scores=t % 2 == 1)
        j = jest.refine(jq, jnp.asarray(mask), pair.mesh, pair.jr.k, jnp.asarray(box), 0.25,
                        jnp.asarray(pair.grid[prev]), **kw)
        o = test.refine(tq, torch.as_tensor(mask), pair.mesh, pair.tr.k, box, 0.25, pair.grid[prev], **kw)
        assert int(o.view_indices) == int(j.view_indices)
        np.testing.assert_allclose(o.tcos.numpy(), np.asarray(j.tcos), atol=1e-5)
        np.testing.assert_allclose(o.scores.numpy(), np.asarray(j.scores), atol=1e-5)


def test_sharded_refine_raises_naming_slice_g(pair):
    """The sharded refine's refusals, as JAX's: no extractor, a
    neighbourhood that does not divide over the "model" axis
    (tests/test_torch_sharded_refine.py holds its results against JAX's)."""
    from freepose_tpu_torch.parallel.mesh import make_mesh

    mesh3 = make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="divide evenly"):
        pair.port_estimator().refine_sharded(None, None, pair.mesh, pair.tr.k, np.zeros(4), 0.25, pair.grid[0],
                                             device_mesh=mesh3)
    with pytest.raises(ValueError, match="requires `extractor`"):
        pair.port_estimator(extractor=False).refine_sharded(None, None, pair.mesh, pair.tr.k, np.zeros(4), 0.25,
                                                            pair.grid[0], device_mesh=mesh3)
    with pytest.raises(ValueError, match="requires `extractor`"):
        ope.OnlinePoseEstimator(pair.tfn, pair.tbank, pair.tr, shard_mesh=mesh3)
