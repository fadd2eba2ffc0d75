"""The sharded fine refine in both packages, on the CPU.

JAX's refine_sharded and its cached composition run on a (2, 4) mesh of
conftest's 8 virtual CPU devices; the port's on make_mesh(2, 4) over the
one `cpu` device repeated, so each of the 4 "model" shards renders and
featurizes its block of the neighbourhood in turn. The scene is
test_torch_online_estimator's: the JAX VIT_TEST weights carried over by
dinov2_from_jax, a coloured blob mesh, 84² renders of a 200-pose grid.

Tolerances: view indices identical; lifted poses and scores within 1e-5,
against JAX's sharded refine and against the port's own unsharded one; the
cached composition's slot map and LRU order equal the unsharded cached
run's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from freepose_tpu.pipeline import online_pose_estimator as jope
from freepose_tpu_torch.parallel.mesh import make_mesh
from freepose_tpu_torch.pipeline import online_pose_estimator as ope
from tests.test_torch_online_estimator import LAYER, N_FINE, Pair, vit_test_params

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return Pair(vit_test_params())


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(data=2, model=4), make_mesh(data=2, model=4, devices=["cpu"] * 8)


def _estimators(pair, jax_mesh=None, port_mesh=None, n_neighbors=8, cap=0, zoom=False):
    j = jope.OnlinePoseEstimator(
        pair.jfn, pair.jbank, pair.jr, n_coarse_poses=16, n_fine_poses=N_FINE, n_neighbors=n_neighbors,
        extractor=pair.jfe, feature_layer=LAYER, fine_cache_capacity=cap, shard_mesh=jax_mesh, zoom_renders=zoom)
    t = ope.OnlinePoseEstimator(
        pair.tfn, pair.tbank, pair.tr, n_coarse_poses=16, n_fine_poses=N_FINE, n_neighbors=n_neighbors,
        extractor=pair.tfe, feature_layer=LAYER, fine_cache_capacity=cap, shard_mesh=port_mesh, zoom_renders=zoom)
    t.fine_poses = torch.as_tensor(pair.grid)
    t._fine_rots_np = pair.grid[:, :3, :3].copy()
    return j, t


def _close(a, b):
    assert int(a.view_indices) == int(b.view_indices)
    np.testing.assert_allclose(np.asarray(a.tcos), np.asarray(b.tcos), atol=ATOL)
    np.testing.assert_allclose(np.asarray(a.scores), np.asarray(b.scores), atol=ATOL)


@pytest.mark.parametrize("zoom", [False, True], ids=["crop", "zoom"])
def test_refine_sharded_matches_jax_and_refine(pair, meshes, zoom):
    jm, pm = meshes
    jest, test = _estimators(pair, zoom=zoom)
    prop, mask, box = pair.query(8)
    jq = jest.coarse.query_features(jnp.asarray(prop))
    tq = test.coarse.query_features(torch.as_tensor(prop))
    for mask_scores in (False, True):
        kw = dict(neighborhood_deg=40.0, mask_scores=mask_scores)
        j = jest.refine_sharded(jq, jnp.asarray(mask), pair.mesh, pair.jr.k, jnp.asarray(box), 0.25,
                                jnp.asarray(pair.grid[7]), device_mesh=jm, **kw)
        o = test.refine_sharded(tq, torch.as_tensor(mask), pair.mesh, pair.tr.k, box, 0.25, pair.grid[7],
                                device_mesh=pm, **kw)
        _close(o, j)
        _close(o, test.refine(tq, torch.as_tensor(mask), pair.mesh, pair.tr.k, box, 0.25, pair.grid[7], **kw))


def test_shards_reassemble_in_mesh_order(pair, meshes):
    """Each shard renders its own block: gathered, the blocks are the
    unsharded prepare's arrays; reassembled in reverse, they are not."""
    _, pm = meshes
    _, test = _estimators(pair)
    v, c, f, fv = pair.tr._padded(pair.mesh, 0.25)
    args = (test.fine_poses, torch.as_tensor(pair.grid[60]), 40.0, v, c, f, fv, pair.tr.k, pair.tr.settings, 8,
            pair.tr.pose_chunk, pair.tr.resolution, pair.tfe, LAYER)
    one = ope._refine_prepare_fused(*args)
    sharded = ope._refine_prepare_fused_sharded(*args, pm, "model")
    for a, b in zip(one[:3], sharded[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(sharded[3].numpy(), one[3].numpy(), atol=ATOL)
    np.testing.assert_array_equal(sharded[4].numpy(), one[4].numpy())
    for a, b in zip(one[5], sharded[5]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL)
    blocks = torch.chunk(one[4], 4)
    assert not torch.equal(torch.cat(blocks[::-1]), sharded[4])


def test_refine_sharded_rejects_uneven_split(pair):
    jest, test = _estimators(pair, n_neighbors=12)
    with pytest.raises(ValueError, match="divide evenly"):
        jest.refine_sharded(jnp.zeros((36, 64)), jnp.zeros((84, 84), bool), pair.mesh, pair.jr.k, jnp.zeros(4),
                            0.25, jnp.asarray(pair.grid[0]), device_mesh=jax_make_mesh(data=1, model=8))
    with pytest.raises(ValueError, match="divide evenly"):
        test.refine_sharded(torch.zeros(36, 64), torch.zeros(84, 84, dtype=torch.bool), pair.mesh, pair.tr.k,
                            np.zeros(4), 0.25, pair.grid[0], device_mesh=make_mesh(1, 8, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="divide evenly"):
        _estimators(pair, port_mesh=make_mesh(1, 8, devices=["cpu"] * 8), n_neighbors=12, cap=16)


@pytest.mark.parametrize("zoom", [False, True], ids=["crop", "zoom"])
def test_cached_composition_matches_jax_and_the_unsharded_cache(pair, meshes, zoom):
    """fine cache + shard_mesh: each miss batch's renders and features
    split over "model" (buckets a multiple of 4); the track equals JAX's
    composition and the port's unsharded cached refine, misses, hits and
    evictions alike, and so do the cache's slot map and LRU order."""
    jm, pm = meshes
    jest, test = _estimators(pair, jax_mesh=jm, port_mesh=pm, cap=12, zoom=zoom)
    _, plain = _estimators(pair, cap=12, zoom=zoom)
    for t, gi in enumerate([5, 6, 5, 120, 121, 5, 60]):
        prop, mask, box = pair.query((gi + 1) % N_FINE)
        kw = dict(neighborhood_deg=40.0, mask_scores=t % 2 == 1)
        j = jest.estimate(jnp.asarray(prop), jnp.asarray(mask), pair.jbank.get("b", pair.mesh), pair.mesh, pair.jr.k,
                          jnp.asarray(box), 0.25, prev_pose=jnp.asarray(pair.grid[gi]), **kw)
        outs = [est.estimate(torch.as_tensor(prop), torch.as_tensor(mask), pair.tbank.get("b", pair.mesh),
                             pair.mesh, pair.tr.k, box, 0.25, prev_pose=pair.grid[gi], **kw) for est in (test, plain)]
        _close(outs[0], j)
        _close(outs[0], outs[1])
    cache, ref = test._fine_caches["b"], plain._fine_caches["b"]
    assert cache.slot_of == ref.slot_of and list(cache.lru) == list(ref.lru)
    assert len(test._fine_caches["b"].slot_of) == 12


def test_estimate_routes_to_the_sharded_paths(pair, meshes, monkeypatch):
    """Uncached, estimate() takes refine_sharded; estimate_frame(fuse=True)
    batches the all-hit objects and sends each miss through the sharded
    cached step (never the fused multi-miss update, which takes no mesh),
    with the serial frame's results."""
    _, pm = meshes
    _, sharded = _estimators(pair, port_mesh=pm)
    _, plain = _estimators(pair)
    prop, mask, box = pair.query(61)
    args = (torch.as_tensor(prop), torch.as_tensor(mask), pair.tbank.get("b", pair.mesh), pair.mesh, pair.tr.k,
            box, 0.25)
    _close(sharded.estimate(*args, prev_pose=pair.grid[60], neighborhood_deg=40.0),
           plain.estimate(*args, prev_pose=pair.grid[60], neighborhood_deg=40.0))

    _, fused = _estimators(pair, port_mesh=pm, cap=16)
    _, serial = _estimators(pair, cap=16)
    from freepose_tpu_torch.pipeline import fine_cache

    def unsharded_multi(*a, **kw):
        raise AssertionError("a sharded estimator took the unsharded multi-miss update")

    monkeypatch.setattr(fine_cache, "cached_refine_update_multi", unsharded_multi)
    objs = []
    for key, gi in (("a", 5), ("b", 120)):
        prop, mask, box = pair.query(gi + 1)
        objs.append(dict(proposal=torch.as_tensor(prop), proposal_mask=torch.as_tensor(mask),
                         pack=pair.tbank.get("b", pair.mesh), mesh=pair.mesh, k=pair.tr.k, bbox=box, est_scale=0.25,
                         prev_pose=pair.grid[gi], cache_key=key))
    for _ in range(2):  # the first frame misses, the second is all-hit
        got = fused.estimate_frame(objs, neighborhood_deg=40.0, fuse=True)
        ref = serial.estimate_frame(objs, neighborhood_deg=40.0)
        for a, b in zip(got, ref):
            _close(a, b)


def test_shard_mesh_checks(pair):
    with pytest.raises(ValueError, match="requires `extractor`"):
        ope.OnlinePoseEstimator(pair.tfn, pair.tbank, pair.tr, shard_mesh=make_mesh(devices=["cpu"]))
    with pytest.raises(ValueError, match="is not the renderer's"):
        ope.OnlinePoseEstimator(pair.tfn, pair.tbank, pair.tr, extractor=pair.tfe,
                                shard_mesh=make_mesh(devices=["meta"]))
