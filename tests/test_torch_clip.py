"""CLIP towers and the BPE tokenizer in the PyTorch port vs the JAX package.

The JAX model's own CLIP_TEST parameters, converted by
models/convert.py:clip_from_jax, and the same numpy images and token ids
go through both packages. Tolerance: fp32 atol 1e-5 on embeddings of
O(0.1-1) (the same arithmetic, summed in another order). Token ids and
normalised pixels must agree exactly (atol 0 / 1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.models.clip import CLIP_TEST as JAX_CLIP_TEST
from freepose_tpu.models.clip import ClipFeatureExtractor as JaxExtractor
from freepose_tpu.models.clip import clip_normalize_images as jax_normalize
from freepose_tpu.models.tokenizer import ClipTokenizer as JaxTokenizer
from freepose_tpu_torch.models.clip import CLIP_TEST, ClipFeatureExtractor, clip_normalize_images
from freepose_tpu_torch.models.tokenizer import ClipTokenizer


@pytest.fixture(scope="module")
def pair():
    jext = JaxExtractor(JAX_CLIP_TEST)
    params = jax.tree_util.tree_map(np.asarray, jext.params)
    return jext, ClipFeatureExtractor(CLIP_TEST, params=params, device="cpu")


def test_image_tower_matches_jax(pair):
    jext, ext = pair
    images = np.random.default_rng(0).random((3, 3, 28, 28)).astype(np.float32)
    ours = ext.encode_image(torch.as_tensor(images)).numpy()
    ref = np.asarray(jext.encode_image(jnp.asarray(images)))
    assert ours.shape == (3, 16)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_text_tower_matches_jax_with_eot_pooling_and_causal_mask(pair):
    """EOT (the highest id, 63) at different positions per row; tokens
    after it must not move the pooled feature (causal mask), in either
    package."""
    jext, ext = pair
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 62, size=(4, 12)).astype(np.int32)
    for row, pos in enumerate((3, 6, 11, 8)):
        ids[row, pos] = 63
    ours = ext.encode_text(ids).numpy()
    ref = np.asarray(jext.encode_text(jnp.asarray(ids)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    after = ids.copy()
    after[0, 4:] = rng.integers(1, 62, size=8)  # row 0's EOT is at 3
    changed = ext.encode_text(after).numpy()
    np.testing.assert_allclose(changed[0], ours[0], atol=1e-6)
    assert np.abs(ours[0] - ext.encode_text(ids[[1, 0, 2, 3]]).numpy()[1]).max() < 1e-6
    eot = torch.as_tensor([3, 6, 11, 8])
    np.testing.assert_allclose(ext.model.text(torch.as_tensor(ids), eot).detach().numpy(), ours, atol=1e-6)


def test_clip_normalize_images_matches_jax():
    images = np.random.default_rng(2).random((2, 3, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(clip_normalize_images(torch.as_tensor(images)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(images))), atol=1e-6)


def test_random_weights_are_seeded_and_drawn_on_the_device():
    a, b = (ClipFeatureExtractor(CLIP_TEST, seed=3, device="cpu") for _ in range(2))
    c = ClipFeatureExtractor(CLIP_TEST, seed=4, device="cpu")
    img = torch.rand((2, 3, 28, 28), generator=torch.Generator().manual_seed(0))
    fa, fb, fc = (e.encode_image(img) for e in (a, b, c))
    torch.testing.assert_close(fa, fb, rtol=0, atol=0)
    assert float((fa - fc).abs().max()) > 1e-3 and torch.isfinite(fa).all()


@pytest.fixture(scope="module")
def bpe_file(tmp_path_factory):
    merges = ["t h", "th e</w>", "c a", "ca t</w>", "d o", "do g</w>", "a</w> ", "m u", "mu g</w>"]
    path = tmp_path_factory.mktemp("bpe") / "vocab.txt"
    path.write_text("#version: 0.2\n" + "\n".join(m for m in merges if m.strip()))
    return path


def test_tokenizer_matches_jax_on_a_written_vocabulary(bpe_file):
    texts = ["the cat", "  The   DOG ", "a mug", "zq x9!", "cat " * 30, "café &amp; mug"]
    ours, ref = ClipTokenizer(bpe_file, context_length=16), JaxTokenizer(bpe_file, context_length=16)
    np.testing.assert_array_equal(ours(texts), ref(texts))
    assert ours.vocab_size == ref.vocab_size and ours.encoder["the</w>"] in ours(["the cat"])[0]
