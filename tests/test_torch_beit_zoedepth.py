"""BEiT and ZoeDepth in the PyTorch port vs the JAX package, on the CPU.

The same parameters (the JAX tree, converted by models/convert.py:
zoedepth_from_jax) and the same numpy inputs go through both packages at the
tiny configs BEIT_TEST / DEPTH_TEST. The relative position tables and
layer scales are random, not the zeros and 0.1 of a fresh init, so the bias
path is exercised.

Tolerances (fp32 throughout, sums in another order): a block atol 3e-5
(the JAX package's own flash-vs-dense tolerance); backbone taps atol 2e-5,
rtol 1e-4; depth atol 2e-5, rtol 1e-4 (the JAX package's HF-parity
tolerances).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import freepose_tpu.ops.attention as jax_attention
from freepose_tpu.models.beit import BEIT_TEST as JAX_BEIT_TEST
from freepose_tpu.models.beit import BeitBackbone as JaxBackbone
from freepose_tpu.models.beit import BeitBlock as JaxBlock
from freepose_tpu.models.zoedepth import DEPTH_TEST as JAX_DEPTH_TEST
from freepose_tpu.models.zoedepth import MetricDepthEstimator as JaxEstimator
from freepose_tpu.models.zoedepth import ZoeDepthModel as JaxZoe
from freepose_tpu_torch.models.beit import BEIT_TEST, BeitBackbone, BeitBlock
from freepose_tpu_torch.models.convert import (random_zoedepth_params, state_dict_from_jax, unstack_scanned,
                                               zoedepth_from_jax)
from freepose_tpu_torch.models.zoedepth import DEPTH_TEST, MetricDepthEstimator, ZoeDepthModel
from freepose_tpu_torch.utils import timing


@pytest.fixture(scope="module")
def params():
    return random_zoedepth_params(DEPTH_TEST, seed=1)


@pytest.mark.parametrize("use_flash", [False, True])
def test_beit_block_matches_jax(use_flash):
    """One block at the pretrain window (4x4 + cls): the dense path, and the
    flash path (the JAX Pallas kernel in interpret mode; the port's
    flash_attention_bias on CPU tensors, its plain version)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 17, 32)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, JaxBlock(JAX_BEIT_TEST, (4, 4)).init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["rel_pos_table"] = rng.normal(scale=0.5, size=params["rel_pos_table"].shape).astype(np.float32)
    params["lambda_1"] = rng.uniform(0.5, 1.0, size=32).astype(np.float32)
    params["lambda_2"] = rng.uniform(0.5, 1.0, size=32).astype(np.float32)

    jax_block = JaxBlock(dataclasses.replace(JAX_BEIT_TEST, use_flash=use_flash), (4, 4))
    old = jax_attention.FORCE_INTERPRET
    jax_attention.FORCE_INTERPRET = use_flash
    try:
        ref = np.asarray(jax_block.apply({"params": params}, jnp.asarray(x)))
    finally:
        jax_attention.FORCE_INTERPRET = old
    block = BeitBlock(dataclasses.replace(BEIT_TEST, use_flash=use_flash))
    block.load_state_dict(state_dict_from_jax(params))
    with timing.tracing(), torch.no_grad():
        before = timing.counts.get("launch.k5", 0)
        ours = block(torch.as_tensor(x), (4, 4)).numpy()
        assert timing.counts.get("launch.k5", 0) == before  # CPU tensors: the plain version
    np.testing.assert_allclose(ours, ref, atol=3e-5)


@pytest.mark.parametrize("hw,window", [((64, 64), (4, 4)), ((64, 80), (4, 5))])
def test_backbone_taps_match_jax(params, hw, window):
    """The pretrain window and a 64x80 input, whose 4x5 window resizes the
    relative position tables with HF's width/height-swapped reshape."""
    pixels = np.random.default_rng(3).normal(size=(1, 3) + hw).astype(np.float32)
    ref, ref_window = JaxBackbone(JAX_BEIT_TEST).apply({"params": params["backbone"]}, jnp.asarray(pixels))
    backbone = BeitBackbone(BEIT_TEST)
    backbone.load_state_dict(state_dict_from_jax(unstack_scanned(params["backbone"], "blocks", "block")))
    with torch.no_grad():
        taps, ours_window = backbone(torch.as_tensor(pixels))
    assert tuple(ours_window) == tuple(ref_window) == window
    assert len(taps) == len(ref) == 4
    for got, want in zip(taps, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 64, 64), (1, 3, 64, 80)])
def test_zoedepth_model_matches_jax(params, shape):
    pixels = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = np.asarray(jax.jit(JaxZoe(JAX_DEPTH_TEST).apply)({"params": params}, jnp.asarray(pixels)))
    for use_flash in (False, True):  # the flash path on CPU tensors runs the plain K5
        cfg = dataclasses.replace(DEPTH_TEST, beit=dataclasses.replace(DEPTH_TEST.beit, use_flash=use_flash))
        model = ZoeDepthModel(cfg)
        model.load_state_dict(zoedepth_from_jax(params))
        with torch.no_grad():
            ours = model(torch.as_tensor(pixels)).numpy()
        assert ours.shape == ref.shape and np.isfinite(ours).all()
        np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)


def test_metric_depth_estimator_predict_matches_jax(params):
    """predict on a 48x80 uint8 image at the pretrain size and at
    input_hw=(64, 80); an input_hw off the patch grid raises in both."""
    img = (np.random.default_rng(5).random((48, 80, 3)) * 255).astype(np.uint8)
    jax_est = JaxEstimator(JAX_DEPTH_TEST, params=params)
    est = MetricDepthEstimator(DEPTH_TEST, params=params, device="cpu")
    for input_hw in (None, (64, 80)):
        ours = est.predict(img, input_hw=input_hw)
        ref = np.asarray(jax_est.predict(img, input_hw=input_hw))
        assert ours.shape == ref.shape == (48, 80) and np.isfinite(ours).all() and (ours >= 0).all()
        np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError):
        est.predict(img, input_hw=(60, 80))


def test_tiny_models_env_selects_the_test_config(monkeypatch):
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    est = MetricDepthEstimator(device="cpu")
    assert est.config == DEPTH_TEST and not est.config.beit.use_flash
