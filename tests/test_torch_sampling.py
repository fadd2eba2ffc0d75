"""freepose_tpu_torch.ops.sampling vs freepose_tpu.ops.sampling, on the CPU.

Every function of the module on the same seeded numpy inputs in both
packages. Tolerance 1e-5 absolute (fp32 separable products on values of
O(1), summed in another order), 1e-4 for the general-factor area resize
(two antialiased linear resamplers with the same triangle kernel, one
matrix product against a gather); boolean outputs agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freepose_tpu.ops import sampling as jax_sampling
from freepose_tpu_torch.ops import sampling

ATOL = 1e-5


def _img(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("in_hw,out_hw", [((420, 420), (30, 30)), ((45, 60), (30, 40)), ((20, 24), (30, 31))])
def test_resize_area_matches_jax(in_hw, out_hw):
    img = _img((2, 3) + in_hw)
    ours = sampling.resize_area(torch.as_tensor(img), out_hw).numpy()
    ref = np.asarray(jax_sampling.resize_area(jnp.asarray(img), out_hw))
    atol = ATOL if in_hw[0] % out_hw[0] == 0 and in_hw[1] % out_hw[1] == 0 else 1e-4
    np.testing.assert_allclose(ours, ref, atol=atol)


@pytest.mark.parametrize("fn", ["resize_bilinear", "resize_bilinear_ac"])
@pytest.mark.parametrize("out_hw", [(64, 96), (17, 13), (40, 40)])
def test_linear_resizes_match_jax_and_torch(fn, out_hw):
    img = _img((2, 40, 40), seed=1)
    ours = getattr(sampling, fn)(torch.as_tensor(img), out_hw)
    ref = np.asarray(getattr(jax_sampling, fn)(jnp.asarray(img), out_hw))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)
    torch_ref = F.interpolate(torch.as_tensor(img)[None], size=out_hw, mode="bilinear",
                              align_corners=fn.endswith("_ac"))[0]
    np.testing.assert_allclose(ours.numpy(), torch_ref.numpy(), atol=ATOL)


def test_bilinear_upsample_of_mask_logits_thresholds_alike():
    """The video predictor's 256² -> 720x1280 mask upsample, thresholded."""
    logits = _img((2, 256, 256), seed=2) * 5
    ours = sampling.resize_bilinear(torch.as_tensor(logits), (720, 1280)) > 0
    ref = np.asarray(jax_sampling.resize_bilinear(jnp.asarray(logits), (720, 1280))) > 0
    assert np.mean(ours.numpy() != ref) < 1e-5


@pytest.mark.parametrize("out_hw", [(14, 14), (64, 48), (7, 9)])
def test_resize_bicubic_torch_matches_jax_and_torch(out_hw):
    img = _img((1, 4, 7, 7), seed=3)
    ours = sampling.resize_bicubic_torch(torch.as_tensor(img), out_hw)
    ref = np.asarray(jax_sampling.resize_bicubic_torch(jnp.asarray(img), out_hw))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)
    torch_ref = F.interpolate(torch.as_tensor(img), size=out_hw, mode="bicubic", align_corners=False)
    np.testing.assert_allclose(ours.numpy(), torch_ref.numpy(), atol=ATOL)


def test_ffa_pool_matches_jax_with_an_empty_mask():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(3, 30 * 30, 16)).astype(np.float32)
    masks = np.zeros((3, 420, 420), bool)
    masks[0, 100:300, 50:200] = True
    masks[1, 5:9, 400:] = True
    ours = sampling.ffa_pool(torch.as_tensor(feats), torch.as_tensor(masks), grid=30).numpy()
    ref = np.asarray(jax_sampling.ffa_pool(jnp.asarray(feats), jnp.asarray(masks), grid=30))
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-6)


def test_roi_align_matches_jax():
    img = _img((3, 40, 50), seed=5)
    boxes = np.array([[3.5, 4.0, 30.2, 36.0], [-5.0, -3.0, 12.0, 8.0], [40.0, 30.0, 60.0, 45.0],
                      [10.0, 10.0, 10.4, 10.3]], np.float32)
    for s in (1, 2, 3):
        ours = sampling.roi_align(torch.as_tensor(img), torch.as_tensor(boxes), 7, 9, sampling_ratio=s)
        ref = np.asarray(jax_sampling.roi_align(jnp.asarray(img), jnp.asarray(boxes), 7, 9, sampling_ratio=s))
        np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)
