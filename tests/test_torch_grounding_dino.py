"""GroundingDINO against the JAX package on the CPU, at GDINO_TEST.

Seeded JAX-layout parameters (models/convert.py:random_grounding_dino_params)
go through both packages (the port's side by grounding_dino_from_jax), with
the same seeded numpy inputs, fp32. Tolerances:
  * the sampling helpers (four taps, and the quad layout with a weight)
    within 1e-5, the sine embeddings within 1e-5, the text masks exactly;
  * the forward's logits: the same finite pattern (-inf past the text and on
    padded tokens), finite values within 1e-4; boxes within 1e-5;
  * detect / detect_batch / detect_topk_device: the same kept queries,
    boxes within 1e-3 px (1e-5 of the 64-80 px images), scores within 1e-5;
  * tied encoder scores (every position's logits equal): the port selects
    the queries in jax.lax.top_k's order, so the outputs agree as above;
  * BiMultiHeadAttention with logits past the ±50000 clip: within atol 1e-4
    and rtol 1e-5 (outputs of O(100)), where a per-row max misses by far.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.models import grounding_dino as J
from freepose_tpu_torch.models import grounding_dino as P
from freepose_tpu_torch.models.convert import grounding_dino_from_jax, random_grounding_dino_params, \
    random_jax_params, state_dict_from_jax
from freepose_tpu_torch.ops.knn import topk_lowest_index

IDS = np.array([[101, 5, 6, 1012, 7, 8, 1012, 102]] * 2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the suite runs several files
    at once, one per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return random_grounding_dino_params(P.GDINO_TEST, seed=0)


def _text_inputs(pad_last: int = 2):
    sa, pos = J.text_token_masks(IDS)
    pad = np.zeros(IDS.shape, bool)
    pad[1, IDS.shape[1] - pad_last:] = True
    return IDS, sa, pos, pad


def _forward_both(tree, pixels):
    inputs = (pixels, *_text_inputs())
    ref = jax.jit(lambda p, *x: J.GroundingDino(J.GDINO_TEST).apply({"params": p}, *x))(
        tree, *(jnp.asarray(a) for a in inputs))
    model = P.GroundingDino(P.GDINO_TEST).eval()
    model.load_state_dict(grounding_dino_from_jax(tree))
    with torch.no_grad():
        ours = model(*(torch.as_tensor(a) for a in inputs))
    return [o.numpy() for o in ours], [np.asarray(r) for r in ref]


def _assert_forward_agrees(ours, ref):
    (logits, boxes), (ref_logits, ref_boxes) = ours, ref
    finite = np.isfinite(ref_logits)
    np.testing.assert_array_equal(np.isfinite(logits), finite)
    assert finite.any() and not finite.all()
    np.testing.assert_allclose(logits[finite], ref_logits[finite], atol=1e-4)
    np.testing.assert_allclose(boxes, ref_boxes, atol=1e-5)


def test_sampling_helpers_match_jax():
    rng = np.random.default_rng(0)
    value = rng.random((3, 5, 7, 4)).astype(np.float32)
    locs = rng.random((3, 64, 2)).astype(np.float32) * 3.0 - 1.5  # far outside the map too
    locs[0, :8] = [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0], [0.0, 0.0], [-0.999, 0.5], [2.9, 0.0],
                   [0.0, -2.9]]
    weight = rng.random((3, 64)).astype(np.float32)
    np.testing.assert_allclose(P.grid_sample_zeros(torch.as_tensor(value), torch.as_tensor(locs)).numpy(),
                               np.asarray(J.grid_sample_zeros(jnp.asarray(value), jnp.asarray(locs))), atol=1e-5)
    for w in (None, weight):
        ours = P.grid_sample_zeros_quad(torch.as_tensor(value), torch.as_tensor(locs),
                                        None if w is None else torch.as_tensor(w))
        ref = J.grid_sample_zeros_quad(jnp.asarray(value), jnp.asarray(locs), None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    # The quad layout with a weight is the four-tap sample times the weight.
    ours = P.grid_sample_zeros_quad(torch.as_tensor(value), torch.as_tensor(locs), torch.as_tensor(weight))
    four = P.grid_sample_zeros(torch.as_tensor(value), torch.as_tensor(locs)) * torch.as_tensor(weight)[..., None]
    np.testing.assert_allclose(ours.numpy(), four.numpy(), atol=1e-5)


def test_position_embeddings_and_text_masks_match_jax():
    for h, w, dim in ((5, 7, 32), (25, 25, 256)):
        np.testing.assert_allclose(P.sine_pos_2d(h, w, dim, 20.0).numpy(),
                                   np.asarray(J.sine_pos_2d(h, w, dim, 20.0)), atol=1e-5)
    vals = np.random.default_rng(1).random((3, 6)).astype(np.float32)
    np.testing.assert_allclose(P.sine_pos_1d(torch.as_tensor(vals), 16).numpy(),
                               np.asarray(J.sine_pos_1d(jnp.asarray(vals), 16)), atol=1e-5)
    boxes = np.random.default_rng(2).random((2, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(P.box_sine_embed(torch.as_tensor(boxes), 32).numpy(),
                               np.asarray(J.box_sine_embed(jnp.asarray(boxes), 32)), atol=1e-5)
    for ids in (IDS, np.array([[101, 103, 1012, 102]]), np.array([[101, 5, 1029, 6, 7, 102, 0, 0]])):
        for ours, ref in zip(P.text_token_masks(ids), J.text_token_masks(ids)):
            np.testing.assert_array_equal(ours, ref)


def test_forward_matches_jax(params):
    pixels = np.random.default_rng(3).normal(size=(2, 3, 64, 96)).astype(np.float32)
    _assert_forward_agrees(*_forward_both(params, pixels))


def test_tied_encoder_scores_select_in_lax_top_k_order(params):
    """A zero enc_output kernel makes every encoder position's output, and
    so its text logits, the same: all scores tie, and the selection order
    alone decides which proposal box and query embedding meet."""
    tree = jax.tree_util.tree_map(np.copy, params)
    tree["enc_output"]["kernel"][:] = 0.0
    pixels = np.random.default_rng(4).normal(size=(2, 3, 64, 96)).astype(np.float32)
    _assert_forward_agrees(*_forward_both(tree, pixels))
    scores = np.random.default_rng(5).integers(0, 4, size=(3, 200)).astype(np.float32)
    values, idx = topk_lowest_index(torch.as_tensor(scores), 50)
    ref_values, ref_idx = jax.lax.top_k(jnp.asarray(scores), 50)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))


def test_bi_attention_clips_after_one_global_max():
    """Vision row 0 and the text are scaled by 300, so row 0's logits reach
    ~1e5 and row 1's sit ~1e5 below the global max: clipped to -50000, all
    alike, so row 1 attends uniformly. A per-row max would not clip them."""
    d, embed, heads = 32, 64, 2
    ours_mod = P.BiMultiHeadAttention(d, embed, heads, torch.float32).eval()
    tree = random_jax_params(ours_mod, seed=6)
    ours_mod.load_state_dict(state_dict_from_jax(tree))
    rng = np.random.default_rng(7)
    vision = rng.normal(size=(2, 3, d)).astype(np.float32)
    vision[:, 0] *= 300.0
    text = rng.normal(size=(2, 5, d)).astype(np.float32) * 300.0
    mask = np.zeros((2, 5), bool)
    mask[1, -1] = True
    ref = jax.jit(lambda p, v, t, m: J.BiMultiHeadAttention(d, embed, heads, jnp.float32).apply(
        {"params": p}, v, t, m))(tree, jnp.asarray(vision), jnp.asarray(text), jnp.asarray(mask))
    with torch.no_grad():
        ours = ours_mod(torch.as_tensor(vision), torch.as_tensor(text), torch.as_tensor(mask))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-5)

    # The same layer with a per-row max: row 1's vision output moves by far.
    with torch.no_grad():
        hd = embed // heads
        vq = ours_mod.vision_proj(torch.as_tensor(vision)).reshape(2, 3, heads, hd).transpose(1, 2) * hd**-0.5
        tk = ours_mod.text_proj(torch.as_tensor(text)).reshape(2, 5, heads, hd).transpose(1, 2)
        tv = ours_mod.values_text_proj(torch.as_tensor(text)).reshape(2, 5, heads, hd).transpose(1, 2)
        logits = vq @ tk.transpose(-1, -2)
        logits = (logits - logits.amax(-1, keepdim=True)).masked_fill(torch.as_tensor(mask)[:, None, None], -np.inf)
        per_row = ours_mod.out_vision_proj((logits.softmax(-1) @ tv).transpose(1, 2).reshape(2, 3, embed))
    miss = np.abs(per_row.numpy() - np.asarray(ref[0]))[:, 1:]
    assert miss.max() > 1.0, miss.max()


@pytest.fixture(scope="module")
def detectors(params):
    return (J.GroundingDinoDetector(J.GDINO_TEST, params, image_size=64),
            P.GroundingDinoDetector(P.GDINO_TEST, params, image_size=64, device="cpu"))


def _threshold(scores: np.ndarray, keep: int) -> float:
    """A threshold between the keep-th and (keep+1)-th highest scores."""
    s = np.sort(scores.ravel())[::-1]
    return float((s[keep - 1] + s[keep]) / 2)


def test_detect_matches_jax(detectors):
    jdet, det = detectors
    rng = np.random.default_rng(8)
    images = [(rng.random((48, 80, 3)) * 255).astype(np.uint8), (rng.random((64, 64, 3)) * 255).astype(np.uint8)]
    _, jscores = jdet.detect(images[0], box_threshold=-1.0)
    thr = _threshold(jscores, 5)
    runs = [[jdet.detect(images[0], box_threshold=thr)], [det.detect(images[0], box_threshold=thr)]]
    runs[0] += jdet.detect_batch(images, box_threshold=thr)
    runs[1] += det.detect_batch(images, box_threshold=thr)
    for (boxes, scores), (ref_boxes, ref_scores) in zip(runs[1], runs[0]):
        assert boxes.shape == ref_boxes.shape and len(boxes) > 0
        np.testing.assert_allclose(boxes, ref_boxes, atol=1e-3)
        np.testing.assert_allclose(scores, ref_scores, atol=1e-5)
    assert len(runs[1][0][0]) == 5
    boxes, scores = det.detect_topk_device(images[1], k=6)
    ref_boxes, ref_scores = jdet.detect_topk_device(images[1], k=6)
    assert isinstance(boxes, torch.Tensor) and boxes.shape == (6, 4)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(ref_boxes), atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-5)


def test_placeholder_prompt_and_tokenizer_ids(detectors, tmp_path):
    """Without a vocabulary the prompt is the JAX detector's placeholder;
    with one, the WordPiece ids of the text."""
    jdet, det = detectors
    np.testing.assert_array_equal(det._prompt_ids(None, "objects."), jdet._prompt_ids(None, "objects."))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]"] * 101 + ["[CLS]", "[SEP]", "objects", "."]))
    with_vocab = P.GroundingDinoDetector(P.GDINO_TEST, None, image_size=64, vocab_path=str(vocab), device="cpu")
    assert with_vocab._prompt_ids(None, "Objects.").tolist() == [[101, 103, 104, 102]]
