"""The fine-view cache and the refine chain, on the CPU.

The port's host bookkeeping (bucket_size, FineViewCache) against the JAX
package's; the port's cached refine against its uncached refine and against
the JAX cached refine (same track, same weights, the JAX pose grid);
AutoRefineChain against the serial closed loop of refine_cached, through
overflow re-dispatches and an adaptive bucket, and against the JAX
package's AutoRefineChain at each lag (the same full re-dispatches and miss
counts); the vectorised LRU victim pick against the JAX step's loop of
argmins; the device cache's invariants; estimate_frame(fuse=True) against
the serial path.

Tolerances: view indices identical, poses and scores within 1e-5 (fp32 ViT
sums in another order, or over other batches).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.pipeline import fine_cache as jfc
from freepose_tpu.pipeline import online_pose_estimator as jope
from freepose_tpu_torch.pipeline import fine_cache
from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain
from tests.test_torch_online_estimator import Pair, blob, vit_test_params

# Wandering across three grid regions: hits, misses and evictions (capacity
# 12 < 3 regions x 8 neighbours) all occur.
WANDER = [5, 6, 5, 120, 121, 5, 60, 61, 120, 5]
CHAIN = [5, 6, 7, 60, 61, 5, 120, 121, 6, 7]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the suite runs several files
    at once, one per worker, and torch's default of one thread per core in
    each worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return Pair(vit_test_params())


def _frames(pair, traj):
    return [pair.query(gi) for gi in traj]


@pytest.mark.parametrize("m,n,multiple", [(1, 32, 1), (4, 32, 1), (5, 32, 1), (11, 32, 1), (17, 32, 1),
                                          (32, 32, 1), (3, 4, 1), (0, 8, 1), (5, 32, 8), (3, 16, 4)])
def test_bucket_size_matches_jax(m, n, multiple):
    assert fine_cache.bucket_size(m, n, multiple=multiple) == jfc.bucket_size(m, n, multiple=multiple)


def test_fine_view_cache_slots_match_jax():
    """One script of assignments, touches and drops through both caches:
    the same slots, LRU order and free list after every call."""
    ours, theirs = fine_cache.FineViewCache(6), jfc.FineViewCache(6)

    def same():
        assert ours.slot_of == theirs.slot_of
        assert list(ours.lru) == list(theirs.lru)
        assert ours.free == theirs.free

    rng = np.random.default_rng(0)
    for step in range(30):
        sel = rng.choice(20, size=4, replace=False).astype(np.int32)
        assert ours.missing(sel) == theirs.missing(sel)
        for c in (ours, theirs):
            c.touch(sel)
        miss = theirs.missing(sel)
        np.testing.assert_array_equal(ours.assign_slots(miss, protect=sel), theirs.assign_slots(miss, protect=sel))
        np.testing.assert_array_equal(ours.gather_slots(sel), theirs.gather_slots(sel))
        if step % 7 == 3:
            for c in (ours, theirs):
                c.drop(sel[:2])
        same()
    ours.ensure_buffers(36, 8, 12, torch.float32, "cpu")
    assert ours.feats.shape == (7, 36, 8) and ours.masks.shape == (7, 12, 12) and ours.stats.shape == (7, 3, 3)


@pytest.mark.parametrize("zoom", [False, True])
def test_refine_cached_equals_refine(pair, zoom):
    """The cached refine reproduces the uncached one along a wandering track
    (the cache holds 12 views, so it evicts)."""
    est_u = pair.port_estimator(cap=0, zoom=zoom)
    est_c = pair.port_estimator(cap=12, zoom=zoom)
    for t, (gi, (prop, mask, box)) in enumerate(zip(WANDER, _frames(pair, [g + 1 for g in WANDER]))):
        kw = dict(neighborhood_deg=40.0, mask_scores=t % 2 == 1)
        q = est_u.coarse.query_features(torch.as_tensor(prop))
        u = est_u.refine(q, torch.as_tensor(mask), pair.mesh, pair.tr.k, box, 0.25, pair.grid[gi], **kw)
        c = est_c.refine_cached(torch.as_tensor(prop), torch.as_tensor(mask), pair.mesh, pair.tr.k, box, 0.25,
                                pair.grid[gi], cache_key="blob", **kw)
        assert int(c.view_indices) == int(u.view_indices), f"frame {t}"
        np.testing.assert_allclose(c.tcos.numpy(), u.tcos.numpy(), atol=1e-5)
        np.testing.assert_allclose(c.scores.numpy(), u.scores.numpy(), atol=1e-5)
    cache = est_c._fine_caches["blob"]
    assert len(cache.slot_of) <= 12 and cache.feats.shape[0] == 13


def test_refine_cached_matches_jax(pair):
    jest, test = pair.estimators(cap=12)
    for t, (gi, (prop, mask, box)) in enumerate(zip(WANDER, _frames(pair, [g + 1 for g in WANDER]))):
        kw = dict(neighborhood_deg=40.0, mask_scores=True, cache_key="blob")
        j = jest.refine_cached(jnp.asarray(prop), jnp.asarray(mask), pair.mesh, pair.jr.k, jnp.asarray(box), 0.25,
                               jnp.asarray(pair.grid[gi]), **kw)
        o = test.refine_cached(torch.as_tensor(prop), torch.as_tensor(mask), pair.mesh, pair.tr.k, box, 0.25,
                               pair.grid[gi], **kw)
        assert int(o.view_indices) == int(j.view_indices), f"frame {t}"
        np.testing.assert_allclose(o.tcos.numpy(), np.asarray(j.tcos), atol=1e-5)
        np.testing.assert_allclose(o.scores.numpy(), np.asarray(j.scores), atol=1e-5)
        np.testing.assert_allclose(o.query_feat.numpy(), np.asarray(j.query_feat), atol=1e-5)
    ours, theirs = test._fine_caches["blob"], jest._fine_caches["blob"]
    assert ours.slot_of == theirs.slot_of and list(ours.lru) == list(theirs.lru)


def _serial(est, pair, frames, prev0):
    out, prev = [], prev0
    for prop, mask, box in frames:
        o = est.refine_cached(torch.as_tensor(prop), torch.as_tensor(mask), pair.mesh, pair.tr.k, box, 0.25, prev,
                              40.0, cache_key="ck")
        tc = o.tcos[0].numpy()
        out.append((tc, float(o.scores[0])))
        prev = tc
    return out


def _check_device_cache(st, capacity):
    table = st.slot_table.numpy()
    grid_of = st.grid_of.numpy()
    n_fine = len(table) - 1
    assert table[n_fine] == -1 and (table < capacity).all()  # never a map to scratch
    occupied = [s for s in range(capacity) if grid_of[s] < n_fine]
    assert len(occupied) <= capacity and grid_of[capacity] == n_fine
    for s in occupied:
        assert table[grid_of[s]] == s
    for gi in np.flatnonzero(table >= 0):
        assert grid_of[table[gi]] == gi
    assert st.last_used[capacity] == -1


@pytest.mark.parametrize("adaptive", [False, True])
def test_auto_chain_matches_serial_closed_loop(pair, adaptive):
    """AutoRefineChain (device slot table, LRU eviction, self-served misses)
    gives the serial closed loop's poses and scores, through frames that
    overflow the stream bucket (full re-dispatch) and, adaptive, a bucket
    that moves up and then down again on a settled tail."""
    traj = CHAIN[:8] + [6] * 24 if adaptive else CHAIN
    frames = _frames(pair, traj)
    prev0 = pair.grid[5]
    serial = _serial(pair.port_estimator(cap=12), pair, frames, prev0)
    est = pair.port_estimator(cap=12)
    kw = dict(adaptive_bucket=True, bucket_choices=(2, 4, 8)) if adaptive else {}
    chain = AutoRefineChain(est, pair.mesh, "ck", neighborhood_deg=40.0, lag=2, miss_bucket=2, **kw)
    for i, (prop, mask, box) in enumerate(frames):
        chain.submit(torch.as_tensor(prop), torch.as_tensor(mask), pair.tr.k, box, 0.25,
                     prev_pose=prev0 if i == 0 else None)
    got = chain.finalize_all()
    assert len(got) == len(serial) == len(traj)
    for t, ((tr, sr), (tg, sg)) in enumerate(zip(serial, got)):
        np.testing.assert_allclose(tg, tr, atol=1e-5, err_msg=f"frame {t}")
        assert abs(sg - sr) < 1e-5
    assert chain.n_full_redispatch > 0
    _check_device_cache(chain.state, 12)
    if adaptive:
        ups = [b for _, b in chain.bucket_switches if b > 2]
        downs = [b for (_, b), (_, b0) in zip(chain.bucket_switches[1:], chain.bucket_switches[:-1]) if b < b0]
        assert ups and downs, chain.bucket_switches


def _victims_loop(last_used, protect, real):
    """The JAX step's victim pick (fine_cache.py:652-665), one argmin per
    batch entry, in numpy."""
    capacity = len(last_used) - 1
    protect = protect.copy()
    out = []
    for r in real:
        cand = np.where(protect, np.iinfo(np.int32).max, last_used)
        v = int(np.argmin(cand))
        if not r or cand[v] == np.iinfo(np.int32).max:
            v = capacity
        out.append(v)
        protect[v] = True
    return np.array(out)


def test_lru_victims_match_the_literal_loop():
    rng = np.random.default_rng(0)
    for case in range(300):
        cap = int(rng.integers(1, 20))
        b = int(rng.integers(1, 12))
        last_used = rng.integers(-1, 6, cap + 1).astype(np.int32)  # many equal ages, free slots
        protect = rng.random(cap + 1) < rng.uniform(0, 0.9)
        protect[cap] = True
        n_real = int(rng.integers(0, b + 1))
        real = np.arange(b) < n_real
        if case % 3 == 0:  # not a prefix: the loop's order still holds
            real = rng.random(b) < 0.6
        ours = fine_cache.lru_victims(torch.as_tensor(last_used), torch.as_tensor(protect), torch.as_tensor(real))
        np.testing.assert_array_equal(ours.numpy(), _victims_loop(last_used, protect, real), err_msg=f"case {case}")


def test_scratch_slot_is_never_read(pair):
    """Padded and unserved writes land in the scratch slot, and a step
    masks every view it gathers from there: the same step on the same state
    gives the same result whatever the scratch slot holds, on a frame whose
    misses overflow the bucket (so some views do gather scratch)."""
    frames = _frames(pair, [5, 120])
    est = pair.port_estimator(cap=12)
    outs = []
    for poison in (False, True):
        chain = AutoRefineChain(est, pair.mesh, "ck", neighborhood_deg=40.0, lag=1, miss_bucket=2)
        chain.submit(torch.as_tensor(frames[0][0]), torch.as_tensor(frames[0][1]), pair.tr.k, frames[0][2], 0.25,
                     prev_pose=pair.grid[5])
        st = chain.state
        if poison:
            st.feats[-1] = 1e3
            st.masks[-1] = True
            st.stats[-1] = float("nan")
        packed, _ = fine_cache.cached_refine_auto_step(
            st, est.fine_poses, torch.as_tensor(pair.grid[120]), torch.as_tensor(pair.grid[120]),
            *est._padded_mesh("ck", pair.mesh), pair.tr.k, torch.as_tensor(frames[1][0]),
            torch.as_tensor(frames[1][1]), pair.tr.k, torch.as_tensor(frames[1][2]), torch.tensor(0.25),
            extractor=est.extractor, layer=est.feature_layer, settings=est.renderer.settings,
            pose_chunk=est.renderer.pose_chunk, resolution=est.renderer.resolution, mask_scores=True,
            rendering_scale=est.rendering_scale, neighborhood_deg=40.0, n_neighbors=8, miss_bucket=2,
        )
        outs.append(packed.numpy())
        _check_device_cache(st, 12)
    assert outs[0][17] == 0 and outs[0][18] > 2  # overflowed: views unserved, masked
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[1], outs[0])


def test_estimate_frame_fused_matches_serial(pair):
    """Two co-tracked objects (two meshes): fuse=True batches the frame's
    hit crops in one ViT call and its miss crops and renders in another,
    with the serial path's results."""
    other = blob(seed=3)
    ests = {fuse: pair.port_estimator(cap=12) for fuse in (False, True)}
    prevs = {fuse: [None, None] for fuse in (False, True)}
    packs = {}
    for est in ests.values():
        packs = {name: est.coarse.bank.get(name, m) for name, m in (("a", pair.mesh), ("b", other))}
    for gi in (5, 6, 6, 120, 121):
        prop, mask, box = pair.query(gi)
        outs = {}
        for fuse, est in ests.items():
            objs = [dict(proposal=torch.as_tensor(prop), proposal_mask=torch.as_tensor(mask), pack=packs[name],
                         mesh=m, k=pair.tr.k, bbox=box, est_scale=0.25, prev_pose=prevs[fuse][i], cache_key=name)
                    for i, (name, m) in enumerate((("a", pair.mesh), ("b", other)))]
            outs[fuse] = est.estimate_frame(objs, neighborhood_deg=40.0, mask_scores=True, fuse=fuse)
            prevs[fuse] = [o.tcos[0] for o in outs[fuse]]
        for a, b in zip(outs[False], outs[True]):
            assert int(a.view_indices) == int(b.view_indices)
            np.testing.assert_allclose(b.tcos.numpy(), a.tcos.numpy(), atol=1e-5)
            np.testing.assert_allclose(b.scores.numpy(), a.scores.numpy(), atol=1e-5)
    for key in ("a", "b"):
        assert ests[True]._fine_caches[key].slot_of == ests[False]._fine_caches[key].slot_of


@pytest.mark.parametrize("mask_scores", [False, True])
@pytest.mark.parametrize("lag", [1, 2, 3])
def test_auto_chain_matches_jax(pair, lag, mask_scores):
    """AutoRefineChain against the JAX package's on the JAX test's
    trajectory (hits, misses, evictions, and jumps that overflow the 2-view
    stream bucket): the same poses and scores, the same full re-dispatches
    and the same misses on every frame."""
    frames = _frames(pair, CHAIN)
    jest, test = pair.estimators(cap=12)
    prev0 = pair.grid[5]
    kw = dict(neighborhood_deg=40.0, mask_scores=mask_scores, lag=lag, miss_bucket=2)
    jchain = jope.AutoRefineChain(jest, pair.mesh, "ck", **kw)
    chain = AutoRefineChain(test, pair.mesh, "ck", **kw)
    for i, (prop, mask, box) in enumerate(frames):
        jchain.submit(jnp.asarray(prop), jnp.asarray(mask), pair.jr.k, jnp.asarray(box), 0.25,
                      prev_pose=jnp.asarray(prev0) if i == 0 else None)
        chain.submit(torch.as_tensor(prop), torch.as_tensor(mask), pair.tr.k, box, 0.25,
                     prev_pose=prev0 if i == 0 else None)
    got, ref = chain.finalize_all(), jchain.finalize_all()
    assert len(got) == len(ref) == len(CHAIN)
    for t, ((tg, sg), (tj, sj)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(tg, tj, atol=1e-5, err_msg=f"frame {t}")
        assert abs(sg - sj) < 1e-5, f"frame {t}"
    assert chain.n_full_redispatch == jchain.n_full_redispatch > 0
    assert chain.miss_counts == jchain.miss_counts
