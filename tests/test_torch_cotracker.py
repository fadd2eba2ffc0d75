"""The point trackers of the PyTorch port vs the JAX package's, on the
same seeded numpy inputs: the ZNCC chain (correlation mode, single and
batched intervals) and the learned CoTracker-style model on one JAX
parameter tree.

Tolerances: tap grids within 1e-6 (the same bilinear weights, summed in
another order); ZNCC scores within 1e-5 and coordinates within 1e-4 pixels;
with planted argmax ties (candidate patches identical bit for bit) the
winners are identical, the first in (dy, dx) row-major order; tracks over a
moving-texture video within 1e-3 pixels and the same visibility; batched
intervals identical to the single-interval chain. Learned model: the
encoder within 1e-5 of its largest output magnitude (fp32 convolutions and
GroupNorms summed in another order, ~2e-6 of it measured; a wrong `SAME`
padding moves outputs by O(1)), tracks within 1e-4 pixels
and visibility within 1e-5 (two CoTracker iterations of fp32 sums in
another order; 5e-5 pixels measured), the query frame pinned exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.models import cotracker as jax_ct
from freepose_tpu_torch.models import cotracker as ct


def _moving_pattern_video(t=6, h=64, w=64, dx=2.0, dy=1.0, seed=0):
    """A textured 16x16 patch moving (dx, dy) pixels per frame."""
    rng = np.random.default_rng(seed)
    patch = rng.random((16, 16, 3)).astype(np.float32)
    video = rng.random((t, h, w, 3)).astype(np.float32) * 0.05
    centers = []
    for f in range(t):
        x0, y0 = int(10 + dx * f), int(20 + dy * f)
        video[f, y0:y0 + 16, x0:x0 + 16] = patch
        centers.append([x0 + 8, y0 + 8])
    return video, np.asarray(centers, np.float32)


def _jax_tracker():
    """The JAX correlation tracker without the init of its learned model's
    parameters, which the correlation mode never reads."""
    tracker = object.__new__(jax_ct.PointTracker)
    tracker.mode = "correlation"
    return tracker


COORDS = np.array([[30.3, 20.7], [3.2, 2.1], [69.9, 57.5], [-2.0, 10.0], [80.0, 65.0]], np.float32)


def test_sampling_and_tap_grids_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((60, 72, 3)).astype(np.float32)
    pts = np.concatenate([COORDS, rng.uniform(-5, 75, size=(20, 2)).astype(np.float32)])
    np.testing.assert_allclose(ct.bilinear_sample(torch.as_tensor(img), torch.as_tensor(pts)).numpy(),
                               np.asarray(jax_ct.bilinear_sample(jnp.asarray(img), jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_allclose(ct._axis_hat_weights(torch.as_tensor(pts[:, 0]), 9, 72).numpy(),
                               np.asarray(jax_ct._axis_hat_weights(jnp.asarray(pts[:, 0]), 9, 72)), atol=1e-6)
    for taps in (9, 25):
        np.testing.assert_allclose(
            ct._extract_tap_grids(torch.as_tensor(img), torch.as_tensor(pts), taps).numpy(),
            np.asarray(jax_ct._extract_tap_grids(jnp.asarray(img), jnp.asarray(pts), taps)), atol=1e-6)


def test_patch_track_step_matches_jax():
    rng = np.random.default_rng(3)
    img0, img1 = (rng.random((60, 72, 3)).astype(np.float32) for _ in range(2))
    new, score = ct.patch_track_step(torch.as_tensor(img0), torch.as_tensor(img1), torch.as_tensor(COORDS))
    new_ref, score_ref = jax_ct.patch_track_step(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(COORDS))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref), atol=1e-5)
    np.testing.assert_allclose(new.numpy(), np.asarray(new_ref), atol=1e-4)


def test_patch_track_step_argmax_ties_match_jax():
    """The next frame repeats every 4 pixels in x and 5 in y, so a point's
    candidates 4 columns or 5 rows apart read the same pixels: equal scores,
    and both packages take the first (dy, dx) in row-major order."""
    rng = np.random.default_rng(4)
    tile = rng.random((5, 4, 3)).astype(np.float32)
    img1 = np.tile(tile, (16, 20, 1))  # 80 x 80
    img0 = rng.random((80, 80, 3)).astype(np.float32)
    coords = np.array([[40.0, 40.0], [33.0, 37.0], [45.0, 30.0]], np.float32)
    new, score = ct.patch_track_step(torch.as_tensor(img0), torch.as_tensor(img1), torch.as_tensor(coords))
    new_ref, score_ref = jax_ct.patch_track_step(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(coords))
    np.testing.assert_array_equal(np.round(new.numpy() - coords), np.round(np.asarray(new_ref) - coords))
    np.testing.assert_allclose(new.numpy(), np.asarray(new_ref), atol=1e-4)
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref), atol=1e-5)
    # The winner is the first of its tied candidates: the offset is in the
    # first period of the search window, [-8, -8 + 4) x [-8, -8 + 5).
    off = np.round(new.numpy() - coords)
    assert ((off[:, 0] < -4) & (off[:, 1] < -3)).all(), off


@pytest.mark.parametrize("query_frame", [0, 3])
def test_point_tracker_matches_jax(query_frame):
    video, centers = _moving_pattern_video()
    queries = np.concatenate([centers[query_frame:query_frame + 1], [[40.5, 44.25], [5.0, 60.0]]]).astype(np.float32)
    tracks, vis = ct.PointTracker(device="cpu").track(video, queries, query_frame=query_frame)
    ref_tracks, ref_vis = _jax_tracker().track(video, queries, query_frame=query_frame)
    assert tracks.shape == (6, 3, 2) and vis.shape == (6, 3)
    np.testing.assert_allclose(tracks, ref_tracks, atol=1e-3)
    np.testing.assert_array_equal(vis, ref_vis)
    assert np.linalg.norm(tracks[:, 0] - centers, axis=-1).max() < 1.5
    # uint8 frames are normalised on the device: the same tracks.
    u8 = (video * 255).astype(np.uint8)
    tr8, _ = ct.PointTracker(device="cpu").track_device(torch.as_tensor(u8), torch.as_tensor(queries), query_frame)
    ref8, _ = _jax_tracker().track_device(u8, queries, query_frame)
    np.testing.assert_allclose(tr8.numpy(), np.asarray(ref8), atol=1e-3)


def _flax_params(seed=0):
    """The JAX learned tracker's own init at COTRACKER_TEST, as numpy."""
    p = jax_ct.CoTracker(jax_ct.COTRACKER_TEST).init(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)),
                                                     jnp.zeros((1, 2)))["params"]
    return jax.tree_util.tree_map(np.array, p)


def _random_tree(seed=1):
    """Seeded random parameters in the JAX layout (non-zero biases, norm
    scales off 1), which the port's converter must carry across too."""
    from freepose_tpu_torch.models.convert import random_cotracker_params

    return random_cotracker_params(ct.COTRACKER_TEST, seed)


@pytest.mark.parametrize("hw", [(32, 40), (33, 47)], ids=["even", "odd"])
def test_basic_encoder_matches_flax(hw):
    """Flax's SAME padding at stride 2 (2 before and 3 after for the 7 x 7
    stem on an even side, 3 and 3 on an odd one)."""
    from freepose_tpu_torch.models.convert import cotracker_from_jax

    params = _random_tree()
    video = np.random.default_rng(0).random((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_ct.BasicEncoder(jax_ct.COTRACKER_TEST).apply({"params": params["encoder"]},
                                                                     jnp.asarray(video)))
    enc = ct.BasicEncoder(ct.COTRACKER_TEST)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in cotracker_from_jax(params).items()
                         if k.startswith("encoder.")})
    with torch.no_grad():
        out = enc(torch.as_tensor(video)).numpy()
    assert out.shape == ref.shape == (2, -(-hw[0] // 4), -(-hw[1] // 4), ct.COTRACKER_TEST.feat_dim)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("query_frame", [0, 3])
def test_learned_tracker_matches_jax(query_frame):
    """PointTracker(mode="learned") on the JAX tracker's parameters (Flax's
    init) and on seeded random ones (every leaf non-zero): tracks and
    visibility as the JAX model's, the query frame pinned to the queries."""
    rng = np.random.default_rng(5)
    video = (rng.random((6, 40, 48, 3)) * 255).astype(np.uint8)
    queries = rng.uniform(4, 36, (9, 2)).astype(np.float32)
    for params in (_flax_params(), _random_tree()):
        ours = ct.PointTracker(ct.COTRACKER_TEST, params=params, mode="learned", device="cpu")
        with torch.no_grad():
            tracks, vis = ours.model(ours._video(video), torch.as_tensor(queries), query_frame)
        ref_tracks, ref_vis = jax_ct.CoTracker(jax_ct.COTRACKER_TEST).apply(
            {"params": params}, jnp.asarray(video, jnp.float32) / 255.0, jnp.asarray(queries), query_frame)
        np.testing.assert_allclose(tracks.numpy(), np.asarray(ref_tracks), atol=1e-4)
        np.testing.assert_allclose(vis.numpy(), np.asarray(ref_vis), atol=1e-5)
        np.testing.assert_array_equal(tracks[query_frame].numpy(), queries)
        assert (vis[query_frame] == 1).all()
        tr_np, vis_np = ours.track(video, queries, query_frame)
        ref_np, ref_vis_np = jax_ct.PointTracker(jax_ct.COTRACKER_TEST, params=params, mode="learned").track(
            video, queries, query_frame)
        np.testing.assert_allclose(tr_np, ref_np, atol=1e-4)
        sure = np.abs(np.asarray(ref_vis) - 0.5) > 1e-5  # away from the threshold
        np.testing.assert_array_equal(vis_np[sure], ref_vis_np[sure])


def test_cotracker_from_jax_layout():
    """The converter's map: Flax's DenseGeneral q/k/v kernels [D, H, Dh] and
    out kernel [H, Dh, D] become Linear weights; convolutions OIHW; norm
    scales weights; the time embedding as it is. The random tree has Flax's
    layout leaf for leaf."""
    from freepose_tpu_torch.models.convert import cotracker_from_jax

    params = _flax_params()
    rand = _random_tree()
    assert jax.tree_util.tree_structure(rand) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(rand), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == np.float32
    sd = cotracker_from_jax(rand)
    model = ct.CoTracker(ct.COTRACKER_TEST)
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    attn = rand["block1"]["space_attn"]
    d = ct.COTRACKER_TEST.hidden_dim
    np.testing.assert_array_equal(sd["block1.space_attn.query.weight"].numpy(), attn["query"]["kernel"].reshape(d, d).T)
    np.testing.assert_array_equal(sd["block1.space_attn.value.bias"].numpy(), attn["value"]["bias"].reshape(d))
    np.testing.assert_array_equal(sd["block1.space_attn.out.weight"].numpy(), attn["out"]["kernel"].reshape(d, d).T)
    np.testing.assert_array_equal(sd["encoder.stem.weight"].numpy(),
                                  rand["encoder"]["stem"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["encoder.res2.norm1.weight"].numpy(), rand["encoder"]["res2"]["norm1"]["scale"])
    np.testing.assert_array_equal(sd["time_embed"].numpy(), rand["time_embed"])


def test_track_device_batch_matches_the_chain_and_jax():
    """Batched intervals: each is the single-interval chain from frame 0,
    the query row (score 1) first, as JAX's _track_chain_batch; learned
    mode refuses; over a device mesh the intervals split, with the same
    results, and a batch that does not divide over the axis refuses."""
    videos = np.stack([_moving_pattern_video(t=4, seed=s, dx=1.0 + s)[0] for s in range(3)])
    queries = np.stack([np.array([[18.0, 28.0], [20.5, 25.25], [5.0, 40.0]], np.float32) + s for s in range(3)])
    tracker = ct.PointTracker(device="cpu")
    tracks, scores = tracker.track_device_batch(torch.as_tensor(videos), torch.as_tensor(queries))
    assert tracks.shape == (3, 4, 3, 2) and scores.shape == (3, 4, 3)
    for i in range(3):
        tr1, sc1 = tracker.track_device(videos[i], queries[i], 0)
        np.testing.assert_array_equal(tracks[i].numpy(), tr1.numpy())
        np.testing.assert_array_equal(scores[i].numpy(), sc1.numpy())
    ref_tracks, ref_scores = jax_ct._track_chain_batch(jnp.asarray(videos), jnp.asarray(queries))
    np.testing.assert_allclose(tracks.numpy(), np.asarray(ref_tracks), atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-5)
    with pytest.raises(ValueError, match="ZNCC-only"):
        ct.PointTracker(ct.COTRACKER_TEST, mode="learned", device="cpu").track_device_batch(videos, queries)
    from freepose_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=3, devices=["cpu"] * 3)
    sharded = tracker.track_device_batch(torch.as_tensor(videos), torch.as_tensor(queries), device_mesh=mesh)
    np.testing.assert_array_equal(sharded[0].numpy(), tracks.numpy())
    np.testing.assert_array_equal(sharded[1].numpy(), scores.numpy())
    with pytest.raises(ValueError, match="must divide over the 'data' axis"):
        tracker.track_device_batch(videos[:2], queries[:2], device_mesh=mesh)
