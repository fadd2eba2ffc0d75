"""The scale stage's ops and estimators in the PyTorch port vs the JAX package.

Connected components and erosion are integer or 0/1 arithmetic: labels,
areas and masks must be identical. Pointcloud reductions, kNN and depth
scales are fp32 over the same inputs: atol 1e-6 on depths of O(1) (masked
median, std, extents) and rtol 1e-5 on scales (sums in another order).
Outlier masks must be identical (the ranks come from stable sorts on both
sides). SVD alignment is compared by extents: the singular vectors' signs
may differ between the packages, the extents do not.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import freepose_tpu.geometry.camera as jcam
import freepose_tpu.geometry.pointcloud as jpc
import freepose_tpu.ops.connected_components as jcc
import freepose_tpu.ops.erosion as jero
import freepose_tpu.ops.knn as jknn
import freepose_tpu.pipeline.scale_estimator as jse
from freepose_tpu.models.clip import CLIP_TEST as JAX_CLIP_TEST
from freepose_tpu.models.clip import ClipFeatureExtractor as JaxClip
from freepose_tpu.pipeline.proposals import Proposals as JaxProposals
from freepose_tpu_torch.geometry import camera, pointcloud
from freepose_tpu_torch.models.clip import CLIP_TEST, ClipFeatureExtractor
from freepose_tpu_torch.ops import connected_components as cc
from freepose_tpu_torch.ops import erosion, knn
from freepose_tpu_torch.pipeline import scale_estimator as se
from freepose_tpu_torch.pipeline.proposals import Proposals


def _blobs(seed: int, shape=(24, 30), density=0.45) -> np.ndarray:
    """A random mask with many components, holes and speckles."""
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < density
    m[5:15, 8:20] = True
    m[9:11, 12:14] = False
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_labels_areas_and_largest_component_identical(seed):
    m = _blobs(seed)
    labels = cc.label_components(torch.as_tensor(m))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jcc.label_components(jnp.asarray(m))))
    np.testing.assert_array_equal(cc.component_areas(labels).numpy(),
                                  np.asarray(jcc.component_areas(jnp.asarray(labels.numpy()))))
    np.testing.assert_array_equal(cc.largest_component(torch.as_tensor(m)).numpy(),
                                  np.asarray(jcc.largest_component(jnp.asarray(m))))
    batch = np.stack([m, ~m])
    for ours, ref in zip(cc.connected_components_batch(torch.as_tensor(batch)),
                         jcc.connected_components_batch(jnp.asarray(batch))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_largest_component_tie_goes_to_the_smallest_label():
    m = np.zeros((10, 12), bool)
    m[6:9, 7:10] = True  # 9 px, found second in raster order
    m[1:4, 1:4] = True   # 9 px, the smallest label
    m[0, 11] = True
    ours = cc.largest_component(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jcc.largest_component(jnp.asarray(m))))
    assert ours[1:4, 1:4].all() and ours.sum() == 9


@pytest.mark.parametrize("fill_holes", [True, False])
@pytest.mark.parametrize("max_area", [1, 4])
def test_remove_small_components_identical(fill_holes, max_area):
    """The JAX function is run unjitted: under its jit `fill_holes` is not
    static, and passing it at all raises a TracerBoolConversionError."""
    m = _blobs(3)
    np.testing.assert_array_equal(
        cc.remove_small_components(torch.as_tensor(m), max_area, fill_holes).numpy(),
        np.asarray(jcc.remove_small_components.__wrapped__(jnp.asarray(m), max_area, fill_holes)))


@pytest.mark.parametrize("radius", [0, 1, 2, 2.5, 4])
def test_isotropic_erosion_identical(radius):
    m = _blobs(4, density=0.8)
    np.testing.assert_array_equal(erosion.isotropic_erosion(torch.as_tensor(m), radius).numpy(),
                                  np.asarray(jero.isotropic_erosion(jnp.asarray(m), radius)))


@pytest.mark.parametrize("box", [(2, 22, 2, 28), (5, 13, 5, 12), (3, 6, 3, 7)])
def test_adaptive_erosion_identical(box):
    """A large box keeps radius 8; smaller ones step down the ladder; a 3x4
    box keeps nothing at radius 1 and falls back to the original mask."""
    m = np.zeros((24, 30), bool)
    y0, y1, x0, x1 = box
    m[y0:y1, x0:x1] = True
    np.testing.assert_array_equal(erosion.adaptive_erosion(torch.as_tensor(m), 8, 25).numpy(),
                                  np.asarray(jero.adaptive_erosion(jnp.asarray(m), 8, 25)))


def _cloud(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    z = rng.normal(2.0, 0.3, n).astype(np.float32)
    z[:5] = 9.0  # outliers
    valid = rng.random(n) < 0.7
    return z, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_reductions_and_outlier_rejection(seed):
    z, valid = _cloud(seed)
    tz, tv, jz, jv = torch.as_tensor(z), torch.as_tensor(valid), jnp.asarray(z), jnp.asarray(valid)
    for v, jvv in ((tv, jv), (tv & (torch.arange(len(z)) != int(np.flatnonzero(valid)[0])),
                              jv & (jnp.arange(len(z)) != int(np.flatnonzero(valid)[0])))):  # odd and even counts
        np.testing.assert_allclose(float(pointcloud.masked_median(tz, v)), float(jpc.masked_median(jz, jvv)),
                                   atol=1e-6)
    np.testing.assert_allclose(float(pointcloud.masked_std(tz, tv)), float(jpc.masked_std(jz, jv)), atol=1e-6)
    for min_vertices in (25, 190):
        np.testing.assert_array_equal(
            pointcloud.reject_depth_outliers(tz, tv, 1.5, min_vertices).numpy(),
            np.asarray(jpc.reject_depth_outliers(jz, jv, 1.5, min_vertices)))
    lo, hi = camera.masked_minmax(tz, tv)
    jlo, jhi = jcam.masked_minmax(jz, jv)
    assert (float(lo), float(hi)) == (float(jlo), float(jhi))
    empty = torch.zeros_like(tv)
    assert float(camera.masked_minmax(tz, empty)[0]) == float(jcam.masked_minmax(jz, jnp.asarray(empty.numpy()))[0])


def test_pointcloud_from_mask_backprojection_svd_and_extent():
    rng = np.random.default_rng(5)
    depth = (1.5 + 0.2 * rng.random((20, 24))).astype(np.float32)
    depth[0, :3] = 0.0
    k = np.array([[60.0, 0, 12], [0, 55.0, 10], [0, 0, 1]], np.float32)
    mask = np.zeros((20, 24), bool)
    mask[3:17, 4:21] = True
    t = [torch.as_tensor(a) for a in (depth, k, mask)]
    j = [jnp.asarray(a) for a in (depth, k, mask)]
    np.testing.assert_allclose(pointcloud.backproject_flat(t[0], t[1]).numpy(),
                               np.asarray(jpc.backproject_flat(j[0], j[1])), atol=1e-6)
    for svd in (False, True):
        pts, valid = pointcloud.pointcloud_from_mask(*t, svd=svd)
        jpts, jvalid = jpc.pointcloud_from_mask(*j, svd=svd)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_allclose(float(pointcloud.bbox_half_extent(pts, valid)),
                                   float(jpc.bbox_half_extent(jpts, jvalid)), rtol=1e-5)
        if svd:  # principal axes: extents per axis up to the vectors' signs
            ext = (pts[valid].max(0).values - pts[valid].min(0).values).numpy()
            jp = np.asarray(jpts)[np.asarray(jvalid)]
            np.testing.assert_allclose(ext, jp.max(0) - jp.min(0), rtol=1e-5)
    np.testing.assert_allclose(camera.default_video_intrinsics(1280, 720).numpy(),
                               np.asarray(jcam.default_video_intrinsics(1280, 720)), rtol=0)


def test_topk_search_and_fine_rerank_scores():
    rng = np.random.default_rng(6)
    bank = rng.normal(size=(50, 16)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    s, i = knn.topk_search(torch.as_tensor(bank), torch.as_tensor(q), 7)
    js, ji = jknn.topk_search(jnp.asarray(bank), jnp.asarray(q), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    fine = rng.normal(size=(5, 12, 16)).astype(np.float32)
    np.testing.assert_allclose(knn.fine_rerank_scores(torch.as_tensor(fine), torch.as_tensor(q[0]), 5).numpy(),
                               np.asarray(jknn.fine_rerank_scores(jnp.asarray(fine), jnp.asarray(q[0]), 5)),
                               atol=1e-6)


@pytest.mark.parametrize("k", [6, 11])
def test_knn_median_lookup_averages_the_middle_pair_at_even_k(k):
    rng = np.random.default_rng(7)
    bank = rng.normal(size=(40, 8)).astype(np.float32)
    values = rng.uniform(0.02, 0.5, 40).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    ours = knn.knn_median_lookup(torch.as_tensor(bank), torch.as_tensor(values), torch.as_tensor(q), k).numpy()
    ref = np.asarray(jknn.knn_median_lookup(jnp.asarray(bank), jnp.asarray(values), jnp.asarray(q), k))
    np.testing.assert_allclose(ours, ref, atol=1e-7)
    _, idx = knn.topk_search(torch.as_tensor(bank), torch.as_tensor(q), k)
    np.testing.assert_allclose(ours, np.median(values[idx.numpy()], axis=-1), atol=1e-7)


def _scene(n_objects: int = 3):
    """Flat squares of known metric size at 2 m, one of them with a speckle
    (so the largest component matters), plus depth noise."""
    rng = np.random.default_rng(8)
    k = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)
    depth = np.zeros((128, 128), np.float32)
    masks = np.zeros((n_objects, 128, 128), bool)
    for i in range(n_objects):
        size, y0 = 24 + 8 * i, 6 + i * 40
        depth[y0:y0 + size, y0:y0 + size] = 2.0 + 0.01 * rng.random((size, size))
        masks[i, y0:y0 + size, y0:y0 + size] = True
    masks[0, 100, 5] = True
    return depth, masks, k


@pytest.mark.parametrize("svd", [False, True])
def test_depth_scales_match_jax(svd):
    depth, masks, k = _scene()
    ours = se.depth_scales(*map(torch.as_tensor, (depth, k, masks)), svd=svd).numpy()
    ref = np.asarray(jse.depth_scales(*map(jnp.asarray, (depth, k, masks)), svd=svd))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    if not svd:  # radius-8 erosion leaves size - 16 px, whose centres span size - 17
        np.testing.assert_allclose(ours, (np.array([24, 32, 40]) - 17) * 2.0 / 100.0 / 2.0, rtol=0.05)


def _proposals(masks, cls):
    boxes = np.array([[xs.min(), ys.min(), xs.max(), ys.max()] for ys, xs in (np.nonzero(m) for m in masks)],
                     np.int32)
    crops = np.random.default_rng(9).random((len(masks), 3, 28, 28)).astype(np.float32)
    if cls is Proposals:
        return Proposals(*map(torch.as_tensor, (crops, masks[:, :28, :28], boxes, masks)))
    return JaxProposals(*map(jnp.asarray, (crops, masks[:, :28, :28], boxes, masks)))


def test_constant_and_mean_estimators_match_jax():
    depth, masks, k = _scene()
    np.testing.assert_array_equal(se.ConstantScaleEstimator(0.1).estimate([1, 2, 3]),
                                  jse.ConstantScaleEstimator(0.1).estimate([1, 2, 3]))
    ours = se.MeanScaleEstimator(0.3).estimate(_proposals(masks, Proposals), depth, k)
    ref = jse.MeanScaleEstimator(0.3).estimate(_proposals(masks, JaxProposals), depth, k)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def _hash_tokenize(names, length=12, vocab=64):
    out = np.zeros((len(names), length), np.int32)
    for i, n in enumerate(names):
        h = abs(hash(n))
        for j in range(length - 1):
            out[i, j] = 1 + (h >> (j * 3)) % (vocab - 2)
        out[i, length - 1] = vocab - 1
    return out


def test_clip_prior_estimator_matches_jax(tmp_path):
    """The same CLIP_TEST weights and prior (20 names, query_k 5); without
    depth, with depth, and from the cached text-feature file of the other
    package."""
    prior = {f"object {i}": 0.1 + 0.05 * i for i in range(20)}
    (tmp_path / "prior.json").write_text(json.dumps(prior))
    jclip = JaxClip(JAX_CLIP_TEST)
    clip = ClipFeatureExtractor(CLIP_TEST, params=jax.tree_util.tree_map(np.asarray, jclip.params), device="cpu")
    ref_est = jse.ClipPriorScaleEstimator(jclip, _hash_tokenize, scale_file=tmp_path / "prior.json",
                                          feats_path=tmp_path / "jax_feats.npz", query_k=5)
    est = se.ClipPriorScaleEstimator(clip, _hash_tokenize, scale_file=tmp_path / "prior.json", query_k=5)
    np.testing.assert_allclose(est.text_features.numpy(), np.asarray(ref_est.text_features), atol=1e-6)
    depth, masks, k = _scene()
    for d, kk in ((None, None), (depth, k)):
        ours = est.estimate(_proposals(masks, Proposals), d, kk)
        ref = ref_est.estimate(_proposals(masks, JaxProposals), d, kk)
        assert ours.shape == (3,) and (ours > 0).all()
        np.testing.assert_allclose(ours, ref, rtol=1e-5)
    cached = se.ClipPriorScaleEstimator(clip, _hash_tokenize, feats_path=tmp_path / "jax_feats.npz")
    np.testing.assert_array_equal(cached.text_features.numpy(), np.asarray(ref_est.text_features))
