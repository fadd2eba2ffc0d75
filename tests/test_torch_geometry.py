"""Geometry and pack statistics of the PyTorch port vs the JAX package on
the same numpy inputs: template poses (atol 1e-6), mask_to_bbox and
crop_resize_pad (exact: integer index arithmetic), backprojection and
depth_stats (atol 1e-5, fp32 sums in another order), score_and_lift
(atol 1e-5 on the lifted poses)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.geometry.boxes import mask_to_bbox as jax_mask_to_bbox
from freepose_tpu.geometry.crop import crop_resize_pad as jax_crop
from freepose_tpu.geometry.rotation import super_fibonacci_quats as jax_quats
from freepose_tpu.geometry.rotation import template_poses as jax_template_poses
from freepose_tpu.pipeline.pose_estimator import score_and_lift as jax_score_and_lift
from freepose_tpu.pipeline.template_bank import depth_stats as jax_depth_stats
from freepose_tpu_torch.geometry.boxes import extend_and_clip_boxes, mask_to_bbox
from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.geometry.rotation import quat_to_matrix, super_fibonacci_quats, template_poses
from freepose_tpu_torch.pipeline.pose_estimator import score_and_lift
from freepose_tpu_torch.pipeline.template_bank import depth_stats, normalize_feats


def test_template_poses_match_jax():
    np.testing.assert_allclose(super_fibonacci_quats(600).numpy(), np.asarray(jax_quats(600)), atol=1e-7)
    ours = template_poses(600).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_template_poses(600)), atol=1e-6)
    r = ours[:, :3, :3]
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape), atol=1e-5)
    np.testing.assert_allclose(ours[:, 2, 3], 1.1)


def test_quat_to_matrix_scalar_last():
    q = torch.tensor([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)])  # 90 deg about z
    np.testing.assert_allclose(quat_to_matrix(q).numpy(), [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6)


def test_mask_to_bbox_matches_jax():
    rng = np.random.default_rng(0)
    masks = np.zeros((5, 30, 40), bool)
    for i in range(4):
        y0, x0 = rng.integers(0, 20), rng.integers(0, 30)
        masks[i, y0 : y0 + rng.integers(1, 10), x0 : x0 + rng.integers(1, 10)] = True
    # masks[4] stays empty: both give (W, H, -1, -1)
    ours = mask_to_bbox(torch.as_tensor(masks)).numpy()
    ref = np.stack([np.asarray(jax_mask_to_bbox(jnp.asarray(m))) for m in masks])
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("extend", [0.0, 0.2])
def test_crop_resize_pad_matches_jax_exactly(extend):
    rng = np.random.default_rng(1)
    n, h, w, target = 6, 37, 53, 24
    images = rng.random((n, 3, h, w)).astype(np.float32)
    x1 = rng.uniform(-5, w - 5, n)
    y1 = rng.uniform(-5, h - 5, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.5, 40, n), y1 + rng.uniform(0.5, 30, n)], 1)
    boxes = boxes.astype(np.float32)
    ours = crop_resize_pad(torch.as_tensor(images), torch.as_tensor(boxes), target, extend=extend)
    ref = np.asarray(jax_crop(jnp.asarray(images), jnp.asarray(boxes), target, extend=extend))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_crop_resize_pad_upsampling_matches_jax():
    """Template views (84²) up to the 420² crop, at every box side 1-84: the
    isotropic scale is target / maxdim in float32 (a reciprocal times
    target rounds otherwise, and floor(bh·scale) then loses the last row)."""
    rng = np.random.default_rng(2)
    side = np.arange(1, 85)
    images = rng.random((len(side), 3, 84, 84)).astype(np.float32)
    x1 = rng.integers(0, 84 - side + 1)
    boxes = np.stack([x1, np.zeros_like(side), x1 + side, np.minimum(side + 3, 84)], 1).astype(np.float32)
    boxes = np.concatenate([boxes, boxes[:, [1, 0, 3, 2]]])  # tall boxes and wide boxes
    images = np.concatenate([images, images])
    ours = crop_resize_pad(torch.as_tensor(images), torch.as_tensor(boxes), 420)
    ref = np.asarray(jax_crop(jnp.asarray(images), jnp.asarray(boxes), 420))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_extend_and_clip_boxes():
    b = torch.tensor([[10.0, 5.0, 30.0, 15.0], [0.0, 0.0, 100.0, 50.0]])
    out = extend_and_clip_boxes(b, 0.2, 64, 48).numpy()
    np.testing.assert_allclose(out, [[6.0, 3.0, 34.0, 17.0], [0.0, 0.0, 64.0, 48.0]])


def _depths():
    rng = np.random.default_rng(2)
    d = np.zeros((4, 20, 24), np.float32)
    d[0, 4:12, 5:15] = rng.uniform(0.9, 1.2, (8, 10))
    d[1, 10:18, 2:9] = rng.uniform(0.5, 0.7, (8, 7))
    d[2] = rng.uniform(1.0, 2.0, (20, 24))
    # d[3] stays empty: a zero-extent cloud at the origin
    return d


def test_depth_stats_match_jax():
    d = _depths()
    k = np.array([[30.0, 0, 12], [0, 30.0, 10], [0, 0, 1]], np.float32)
    ours = depth_stats(torch.as_tensor(d), torch.as_tensor(k), chunk=3)
    ref = jax_depth_stats(jnp.asarray(d), jnp.asarray(k))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(ours[0][3].numpy(), 0.0)


def test_score_and_lift_matches_jax():
    rng = np.random.default_rng(3)
    v, g, d = 40, 9, 16
    feats = np.asarray(normalize_feats(torch.as_tensor(rng.normal(size=(v, g, d)).astype(np.float32))))
    q = np.asarray(normalize_feats(torch.as_tensor(rng.normal(size=(g, d)).astype(np.float32))))
    pc_min = rng.uniform(-0.3, -0.1, (v, 3)).astype(np.float32)
    pc_max = rng.uniform(0.1, 0.3, (v, 3)).astype(np.float32)
    pc_mean = rng.uniform(-0.05, 0.05, (v, 3)).astype(np.float32)
    pc_mean[:, 2] += 1.1
    poses = np.array(jax_template_poses(v))
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    bbox = np.array([200.0, 150.0, 320.0, 260.0], np.float32)
    args = (feats, q, pc_min, pc_max, pc_mean, poses, k, bbox, np.float32(0.08))
    tcos, scores, idx, all_scores = score_and_lift(*map(torch.as_tensor, args), 3, return_all_scores=True)
    jt, js, ji, ja = jax_score_and_lift(*map(jnp.asarray, args), 3, return_all_scores=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(all_scores.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jt), atol=1e-5)


def test_score_and_lift_ties_keep_lower_view_index():
    feats = torch.zeros(6, 1, 2)
    feats[[1, 3, 4], 0, 0] = 1.0  # three views tie for the best score
    q = torch.tensor([[1.0, 0.0]])
    ones = torch.ones(6, 3)
    _, scores, idx = score_and_lift(feats, q, -ones, ones, 0 * ones, template_poses(6),
                                    torch.eye(3), torch.tensor([0.0, 0.0, 9.0, 9.0]), torch.tensor(0.1))
    assert idx.tolist() == [1, 3, 4]
    # lax.top_k breaks ties the same way
    _, jidx = jax.lax.top_k(jnp.asarray(scores.new_tensor([0, 1, 0, 1, 1, 0]).numpy()), 3)
    assert np.asarray(jidx).tolist() == [1, 3, 4]
