"""CoTracker2 of the PyTorch port vs the JAX package at COTRACKER2_TEST,
fp32, the JAX side at precision "highest", on seeded random weights in the
JAX layout (random_cotracker2_params) carried over by cotracker2_from_jax.

Tolerances: the encoder within 2e-4 and the update former within 5e-4
(fp32 convolutions and products summed in another order); one window at one
iteration: tracks and visibility logits within 1e-4. Random weights make the
iterated tracker chaotic: at a second iteration the JAX model alone moves
1.5e-2 pixels for a 1e-3 change of the input's 0-255 pixels, so the
multi-window forward (two iterations) and the predictor run with the flow
head scaled by 0.02, as the JAX package's tests do: tracks within 2e-3
pixels there. The converter is exact
both ways, and the JAX converter of the released checkpoint
(cotracker2_from_hub) reads the port's state dict back into the JAX tree
exactly, which pins the released key layout.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.models import convert as jax_convert
from freepose_tpu.models import cotracker2 as jc
from freepose_tpu_torch.models import convert
from freepose_tpu_torch.models import cotracker2 as ct2

CFG = ct2.COTRACKER2_TEST
JCFG = jc.COTRACKER2_TEST
QUERIES = np.array([[0, 10.5, 20.0], [0, 40.0, 30.0], [3, 25.0, 12.5]], np.float32)


@pytest.fixture(scope="module")
def params():
    return convert.random_cotracker2_params(CFG, seed=0)


@pytest.fixture(scope="module")
def tame(params):
    p = jax.tree.map(np.array, params)
    for name in ("kernel", "bias"):
        p["updateformer"]["flow_head"][name] *= np.float32(0.02)
    return p


def _model(p):
    m = ct2.CoTracker2(CFG)
    m.load_state_dict(convert.cotracker2_from_jax(p))
    return m.eval()


def test_embeddings_and_sampling_match_jax():
    xy = np.random.RandomState(0).uniform(-5, 30, (3, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(ct2.flow_embedding(torch.as_tensor(xy), CFG.flow_emb_dim).numpy(),
                               np.asarray(jc.flow_embedding(jnp.asarray(xy), JCFG.flow_emb_dim)), atol=1e-5)
    np.testing.assert_array_equal(ct2.pos_embedding_2d(24, (5, 7)), jc.pos_embedding_2d(24, (5, 7)))
    np.testing.assert_array_equal(ct2.time_embedding(24, 8), jc.time_embedding(24, 8))
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((6, 9, 11)).astype(np.float32)
    # Centres inside, on and past the borders (border padding clamps each tap).
    centers = np.array([[5.3, 4.1], [0.0, 0.0], [10.0, 8.0], [-3.2, 2.5], [12.7, 9.9], [4.5, -6.0]], np.float32)
    np.testing.assert_allclose(ct2.sample_windows(torch.as_tensor(vol), torch.as_tensor(centers), 2).numpy(),
                               np.asarray(jc.sample_windows(jnp.asarray(vol), jnp.asarray(centers), 2)), atol=1e-6)
    fmap = rng.standard_normal((9, 11, 5)).astype(np.float32)
    for border in (False, True):
        np.testing.assert_allclose(
            ct2.sample_features_nd(torch.as_tensor(fmap), torch.as_tensor(centers), border).numpy(),
            np.asarray(jc.sample_features_nd(jnp.asarray(fmap), jnp.asarray(centers), border)), atol=1e-6)


def test_encoder_matches_jax(params):
    x = np.random.RandomState(1).uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
    with torch.no_grad():
        ours = _model(params).fnet(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ref = jc.BasicEncoder(JCFG).apply({"params": params["fnet"]}, jnp.asarray(x))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-4)


def test_update_former_with_fully_masked_rows_matches_jax(params):
    n, t = 5, CFG.window_len
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, (n, t, CFG.input_dim)).astype(np.float32)
    mask = rs.rand(t, n) > 0.3
    mask[:, 0] = True
    mask[:, 3] = False  # a point absent on every frame: its rows attend uniformly
    mask[5] = False  # a frame with no point: the virtual tracks' rows attend uniformly
    with torch.no_grad():
        ours = _model(params).updateformer(torch.as_tensor(x), torch.as_tensor(mask)).numpy()
    ref = jc.EfficientUpdateFormer(JCFG).apply({"params": params["updateformer"]}, jnp.asarray(x), jnp.asarray(mask))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=5e-4)


_jax_apply = jax.jit(partial(jc.CoTracker2(JCFG).apply), static_argnums=3)


def _forward(p, t, iters):
    video = np.random.RandomState(3).uniform(0, 255, (t, 48, 64, 3)).astype(np.float32)
    with torch.no_grad():
        tracks, vis = _model(p)(torch.as_tensor(video), torch.as_tensor(QUERIES), iters)
    ref_tracks, ref_vis = _jax_apply({"params": p}, jnp.asarray(video), jnp.asarray(QUERIES), iters)
    return tracks.numpy(), vis.numpy(), np.asarray(ref_tracks), np.asarray(ref_vis)


def test_one_window_matches_jax(params):
    tracks, vis, ref_tracks, ref_vis = _forward(params, CFG.window_len, iters=1)
    np.testing.assert_allclose(tracks, ref_tracks, atol=1e-4)
    np.testing.assert_allclose(vis, ref_vis, atol=1e-4)
    np.testing.assert_allclose(tracks[:3, 2], np.broadcast_to(QUERIES[2, 1:], (3, 2)), atol=1e-5)  # before its frame


def test_multi_window_matches_jax(tame):
    t = 12  # two windows: the second starts from the first's overlap
    tracks, vis, ref_tracks, ref_vis = _forward(tame, t, iters=2)
    np.testing.assert_allclose(tracks, ref_tracks, atol=2e-3)
    np.testing.assert_allclose(vis, ref_vis, atol=2e-3)


def test_predictor_backward_pass_and_pinning_match_jax(tame):
    video = (np.random.RandomState(4).rand(9, 50, 70, 3) * 255).astype(np.uint8)
    queries = np.array([[0, 12.0, 20.0], [4, 30.0, 25.0]], np.float32)
    ours = ct2.CoTracker2Predictor(tame, CFG, support_grid_size=2, device="cpu")
    ref = jc.CoTracker2Predictor(tame, JCFG, support_grid_size=2)
    tracks, vis = ours(video, queries, backward_tracking=True)
    ref_tracks, ref_vis = ref(video, queries, backward_tracking=True)
    np.testing.assert_allclose(tracks, ref_tracks, atol=2e-3)
    np.testing.assert_array_equal(vis, ref_vis)
    np.testing.assert_allclose(tracks[4, 1], [30.0, 25.0], atol=1e-4)
    assert vis[0, 0] and vis[4, 1]
    # The PointTracker interface: float video in [0, 1], queries on frame 2.
    q2 = np.array([[10.0, 15.0], [30.0, 20.0]], np.float32)
    tracks, vis = ours.track(video.astype(np.float32) / 255.0, q2, query_frame=2)
    ref_tracks, ref_vis = ref.track(video.astype(np.float32) / 255.0, q2, query_frame=2)
    np.testing.assert_allclose(tracks, ref_tracks, atol=2e-3)
    np.testing.assert_array_equal(vis, ref_vis)
    np.testing.assert_allclose(tracks[2], q2, atol=1e-4)


def test_converters_round_trip_and_released_layout(params):
    sd = convert.cotracker2_from_jax(params)
    back = convert.cotracker2_to_jax({k: v.numpy() for k, v in sd.items()})
    jax.tree.map(np.testing.assert_array_equal, back, params)
    model = _model(params)
    assert set(model.state_dict()) == set(sd) and "updateformer.virual_tracks" in sd
    # The JAX package's converter of the released checkpoint reads the
    # port's state dict back into the JAX tree.
    hub = jax_convert.cotracker2_from_hub({k: v.numpy() for k, v in model.state_dict().items()}, depth=CFG.depth)
    jax.tree.map(np.testing.assert_array_equal, hub, params)


def test_random_params_have_the_released_tree():
    rand = convert.random_cotracker2_params(ct2.COTRACKER2, seed=0)
    want = jax.eval_shape(lambda: jc.CoTracker2Predictor.init_params(jc.COTRACKER2))
    assert jax.tree.map(np.shape, rand) == jax.tree.map(lambda a: tuple(a.shape), want)
    assert rand["vis_predictor"]["bias"][0] > convert.VISIBILITY_BIAS - 1
    np.testing.assert_array_equal(convert.random_cotracker2_params(ct2.COTRACKER2, seed=0)["fnet"]["conv1"]["kernel"],
                                  rand["fnet"]["conv1"]["kernel"])
