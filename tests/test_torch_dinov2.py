"""DINOv2 in the PyTorch port vs the JAX package: the JAX model's own
parameters, converted with dinov2_from_jax, give the same tokens (fp32,
atol 1e-4) at the native grid, one grid below and one above, full depth and
truncated at layer 2, and in bf16. Also the numerical places where a port
can drift: tanh-GELU and antialiased bicubic position-embedding resampling.
And what the CPU sees of the single-image CUDA graphs: none is kept here,
the extractor's resident normalization constants, copies without graphs
(the card-only checks are in test_torch_cuda_kernels.py)."""
import copy
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
from freepose_tpu.models.dinov2 import DinoFeatureExtractor as JaxExtractor
from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from freepose_tpu.models.vit import interpolate_pos_embed as jax_interp
from freepose_tpu_torch.models.convert import dinov2_from_jax
from freepose_tpu_torch.models.dinov2 import (IMAGENET_MEAN, IMAGENET_STD, VIT_TEST, DinoFeatureExtractor, DinoV2,
                                              normalize_images)
from freepose_tpu_torch.models.vit import interpolate_pos_embed


@pytest.fixture(scope="module")
def params():
    """JAX-initialised params with non-trivial LayerScale, cls and register
    tokens, so every branch of the block mixes."""
    p = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    p = jax.tree_util.tree_map(np.array, p)
    rng = np.random.default_rng(0)
    blk = p["blocks"]["block"]
    blk["ls1"]["gamma"] = rng.uniform(0.2, 0.8, blk["ls1"]["gamma"].shape).astype(np.float32)
    blk["ls2"]["gamma"] = rng.uniform(0.2, 0.8, blk["ls2"]["gamma"].shape).astype(np.float32)
    p["cls_token"] = rng.normal(size=p["cls_token"].shape).astype(np.float32)
    p["reg_tokens"] = rng.normal(size=p["reg_tokens"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("size", [56, 42, 84])  # native 4x4 grid, 3x3 below, 6x6 above
@pytest.mark.parametrize("layer", [None, 2])
def test_tokens_match_jax(params, size, layer):
    model = DinoV2(VIT_TEST)
    model.load_state_dict(dinov2_from_jax(params))
    img = np.random.default_rng(size).normal(size=(2, 3, size, size)).astype(np.float32)
    ref = np.asarray(JaxDinoV2(JAX_VIT_TEST).apply({"params": params}, jnp.asarray(img), layer=layer))
    with torch.no_grad():
        ours = model(torch.as_tensor(img), layer=layer).numpy()
    assert ours.shape == ref.shape == (2, 1 + 4 + (size // 14) ** 2, 64)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("size,layer,atol", [(56, 0, 0.0), (84, 0, 4e-3), (56, 2, 4e-2), (84, 2, 4e-2)])
def test_bf16_tokens_match_jax(params, size, layer, atol):
    """bf16 in both packages. Layer 0 (embeddings + final norm) at the native
    grid is bit-identical, which holds only if cls/register/position tokens
    are added in fp32 before the cast, as the JAX model does; resampled
    position embeddings differ in the last fp32 bits (one bf16 step at most),
    and two blocks of bf16 products in another order differ by two bf16
    steps at |x| ≈ 4."""
    jcfg = dataclasses.replace(JAX_VIT_TEST, dtype=jnp.bfloat16)
    model = DinoV2(dataclasses.replace(VIT_TEST, dtype=torch.bfloat16))
    model.load_state_dict(dinov2_from_jax(params))
    img = np.random.default_rng(size).normal(size=(2, 3, size, size)).astype(np.float32)
    ref = JaxDinoV2(jcfg).apply({"params": params}, jnp.asarray(img, jnp.bfloat16), layer=layer)
    with torch.no_grad():
        ours = model(torch.as_tensor(img).to(torch.bfloat16), layer=layer)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol, rtol=0)


def test_truncation_skips_unused_blocks(params):
    model = DinoV2(VIT_TEST)
    model.load_state_dict(dinov2_from_jax(params))
    ran = []
    for i, blk in enumerate(model.blocks):
        blk.register_forward_hook(lambda *_, i=i: ran.append(i))
    with torch.no_grad():
        model(torch.zeros(1, 3, 56, 56), layer=2)
    assert ran == [0, 1]


def test_feature_extractor_matches_jax(params):
    img = np.random.default_rng(7).random((2, 3, 56, 56)).astype(np.float32)
    ours = DinoFeatureExtractor(VIT_TEST, params=params, device="cpu")
    ref = JaxExtractor(JAX_VIT_TEST, params=params)
    for ft, shape in (("patch", (2, 16, 64)), ("cls", (2, 64)), ("reg", (2, 4, 64))):
        out = ours(torch.as_tensor(img), layer=2, feature_type=ft)
        assert out.shape == shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref(jnp.asarray(img), layer=2, feature_type=ft)),
                                   atol=1e-4)


def test_gelu_is_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ours = F.gelu(torch.as_tensor(x), approximate="tanh").numpy()
    np.testing.assert_allclose(ours, np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)
    assert np.abs(F.gelu(torch.as_tensor(x)).numpy() - ours).max() > 1e-4  # erf form differs


@pytest.mark.parametrize("src,dst", [(37, 30), (4, 6)])
def test_pos_embed_resampling_matches_jax(src, dst):
    pe = np.random.default_rng(src).normal(size=(1, src * src, 8)).astype(np.float32)
    ours = interpolate_pos_embed(torch.as_tensor(pe), (dst, dst), src).numpy()
    ref = np.asarray(jax_interp(jnp.asarray(pe), (dst, dst), src))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_forward_keeps_no_graph_on_the_cpu():
    """Single images under inference mode, the calls a card graphs, run
    eagerly on the CPU and leave no graph and no key seen."""
    ext = DinoFeatureExtractor(VIT_TEST, device="cpu")
    img = torch.rand(1, 3, 56, 56, generator=torch.Generator().manual_seed(0))
    outs = [ext(img, layer=2) for _ in range(3)]
    with torch.inference_mode():
        outs += [ext.model(normalize_images(img, ext.stats), layer=None) for _ in range(3)]
    assert len(ext.model._graphs) == 0 and ext.model._graphs.seen == {}
    for out in outs[1:3]:
        assert torch.equal(out, outs[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_stats_normalize_as_normalize_images(dtype):
    """The extractor's mean and std, made once, give the bits of the mean
    and std made for each call in the images' dtype, and so the same
    features."""
    ext = DinoFeatureExtractor(dataclasses.replace(VIT_TEST, dtype=dtype), device="cpu")
    assert all(s.dtype == dtype and s.shape == (1, 3, 1, 1) for s in ext.stats)
    img = torch.rand(2, 3, 56, 56, generator=torch.Generator().manual_seed(1)).to(dtype)
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=dtype).reshape(1, 3, 1, 1)
    assert torch.equal(normalize_images(img, ext.stats), (img - mean) / std)
    with torch.inference_mode():
        ref = ext.model((img - mean) / std, layer=2)[:, 5:]
    assert torch.equal(ext(img, layer=2), ref)


def test_copies_carry_no_graph_over():
    """A replica (DinoFeatureExtractor.replica, parallel/mesh.py:replicate)
    starts with no graph and no key seen, though a graph cannot be copied
    (a lock stands in for one here); moving or casting a model drops its
    graphs and keeps the keys seen."""
    from freepose_tpu_torch.parallel.mesh import _replica

    ext = DinoFeatureExtractor(VIT_TEST, device="cpu")
    key = ((56, 56), torch.float32, 2, torch.device("cuda", 0))
    ext.model._graphs.graphs[key], ext.model._graphs.seen[key] = threading.Lock(), 2
    meta = torch.device("meta")
    for copied in (ext.replica(meta).model, _replica(ext.model, meta), copy.deepcopy(ext.model)):
        assert copied is not ext.model and len(copied._graphs) == 0 and copied._graphs.seen == {}
    assert all(s.device == meta for s in ext.replica(meta).stats)
    assert key in ext.model._graphs.graphs and ext.model._graphs.seen == {key: 2}
    ext.model.to(torch.float32)
    assert len(ext.model._graphs) == 0 and ext.model._graphs.seen == {key: 2}
