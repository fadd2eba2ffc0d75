"""The ZNCC point tracker of the PyTorch port vs the JAX package's
correlation mode, on the same seeded numpy inputs.

Tolerances: tap grids within 1e-6 (the same bilinear weights, summed in
another order); ZNCC scores within 1e-5 and coordinates within 1e-4 pixels;
with planted argmax ties (candidate patches identical bit for bit) the
winners are identical, the first in (dy, dx) row-major order; tracks over a
moving-texture video within 1e-3 pixels and the same visibility.
"""
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


def test_learned_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        ct.PointTracker(mode="learned", device="cpu")
