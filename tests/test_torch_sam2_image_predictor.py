"""Sam2ImagePredictor against the JAX package's on the CPU.

SAM2_TEST (64² model input) on a 48x80 uint8 image, with one .npz-layout
tree of seeded parameters (models/convert.py:random_sam2_image_params) in
both packages, fp32. Box and point prompts give the same bool masks at the
original resolution and IoU scores within 1e-4 (low-res logits within 1e-4
too); boxes decoded as one batched prompt set equal the same boxes decoded
one by one; a prompt set padded to its graph bucket by repeating its last
prompt gives the unpadded set's rows; return_logits gives the JAX logits
within 1e-4, and predict_device the same masks on the device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.models.sam2.model import SAM2_TEST as JAX_SAM2_TEST
from freepose_tpu.models.sam2.predictor import Sam2ImagePredictor as JaxPredictor
from freepose_tpu.models.sam2.predictor import scale_coords as jax_scale_coords
from freepose_tpu_torch.models.convert import random_sam2_image_params
from freepose_tpu_torch.models.sam2.model import SAM2_TEST
from freepose_tpu_torch.models.sam2.predictor import (Sam2ImagePredictor, _decode_masks, pad_prompts, prompt_bucket,
                                                     scale_coords)

ATOL = 1e-4
BOXES = np.array([[10, 10, 60, 40], [5, 20, 30, 45], [40, 2, 78, 30], [0, 0, 80, 48]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the suite runs several files
    at once, one per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def predictors():
    tree = random_sam2_image_params(SAM2_TEST, seed=0)
    image = (np.random.default_rng(0).random((48, 80, 3)) * 255).astype(np.uint8)
    jax_pred = JaxPredictor(JAX_SAM2_TEST, tree, image_size=64)
    ours = Sam2ImagePredictor(SAM2_TEST, tree, image_size=64, device="cpu")
    jax_pred.set_image(jnp.asarray(image))
    ours.set_image(image)
    return jax_pred, ours


def _assert_same(ours, ref):
    masks, iou, low = ours
    ref_masks, ref_iou, ref_low = ref
    assert masks.dtype == bool and masks.shape == ref_masks.shape
    np.testing.assert_array_equal(masks, ref_masks)
    np.testing.assert_allclose(iou, ref_iou, atol=ATOL)
    np.testing.assert_allclose(low, ref_low, atol=ATOL)


@pytest.mark.parametrize("prompt", [
    dict(box=BOXES, multimask_output=False),
    dict(box=BOXES[0]),
    dict(point_coords=np.array([[32.0, 20.0]]), point_labels=np.array([1]), multimask_output=False),
    dict(point_coords=np.array([[[32.0, 20.0], [70.0, 40.0]], [[5.0, 5.0], [60.0, 10.0]]]),
         point_labels=np.array([[1, 0], [1, 1]])),
], ids=["boxes", "box_multimask", "point", "two_point_sets"])
def test_predict_matches_jax(predictors, prompt):
    jax_pred, ours = predictors
    _assert_same(ours.predict(**prompt), jax_pred.predict(**prompt))


def test_batched_boxes_equal_sequential(predictors):
    _, ours = predictors
    masks, iou, low = ours.predict(box=BOXES, multimask_output=False)
    for i, box in enumerate(BOXES):
        m, s, lo = ours.predict(box=box, multimask_output=False)
        np.testing.assert_array_equal(m[0], masks[i])
        np.testing.assert_allclose(s[0], iou[i], atol=1e-5)
        np.testing.assert_allclose(lo[0], low[i], atol=1e-5)


@pytest.mark.parametrize("prompt", [
    dict(box=BOXES),
    dict(box=BOXES[2:3]),
    dict(point_coords=np.array([[[32.0, 20.0], [70.0, 40.0]], [[5.0, 5.0], [60.0, 10.0]]]),
         point_labels=np.array([[1, 0], [1, 1]])),
], ids=["four_boxes", "one_box", "two_point_sets"])
def test_padded_prompts_decode_as_unpadded(predictors, prompt):
    """The graphed decode's padding (models/sam2/predictor.py:pad_prompts):
    the prompt set repeated at its last prompt up to the bucket of 16 rows
    decodes its first P rows as the unpadded set does."""
    _, ours = predictors
    prompts = ours._scale_prompts(prompt.get("point_coords"), prompt.get("point_labels"), prompt.get("box"))
    n = next(p.shape[1] for p in prompts if p is not None)
    padded = pad_prompts(prompts, prompt_bucket(n))
    assert all(p is None or p.shape[1] == 16 for p in padded)
    with torch.inference_mode():
        masks, iou = _decode_masks(ours.model, ours._pyramid, prompts, False)
        pad_masks, pad_iou = _decode_masks(ours.model, ours._pyramid, padded, False)
    assert pad_masks.shape[0] == 16
    np.testing.assert_allclose(pad_masks[:n].numpy(), masks.numpy(), atol=1e-5)
    np.testing.assert_array_equal(pad_masks[:n].numpy() > 0, masks.numpy() > 0)
    np.testing.assert_allclose(pad_iou[:n].numpy(), iou.numpy(), atol=1e-5)


@pytest.mark.parametrize("n,bucket", [(1, 16), (4, 16), (12, 16), (16, 16), (17, 32), (40, 48)])
def test_prompt_bucket(n, bucket):
    assert prompt_bucket(n) == bucket


def test_return_logits_and_predict_device(predictors):
    jax_pred, ours = predictors
    logits, _, none = ours.predict(box=BOXES, multimask_output=False, return_logits=True,
                                   fetch_low_res_logits=False)
    ref_logits, _, _ = jax_pred.predict(box=BOXES, multimask_output=False, return_logits=True)
    assert none is None and logits.dtype == np.float32
    np.testing.assert_allclose(logits, ref_logits, atol=ATOL)
    masks, iou = ours.predict_device(box=torch.as_tensor(BOXES), multimask_output=False)
    ref_masks, ref_iou = jax_pred.predict_device(box=jnp.asarray(BOXES), multimask_output=False)
    assert isinstance(masks, torch.Tensor) and masks.dtype == torch.bool
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref_masks))
    np.testing.assert_allclose(iou.numpy(), np.asarray(ref_iou), atol=ATOL)
    coords = np.array([[3.0, 4.0], [79.0, 47.0]], np.float32)
    np.testing.assert_allclose(scale_coords(torch.as_tensor(coords), (48, 80), 64).numpy(),
                               np.asarray(jax_scale_coords(jnp.asarray(coords), (48, 80), 64)), atol=1e-6)


def test_predict_needs_an_image():
    pred = Sam2ImagePredictor(SAM2_TEST, random_sam2_image_params(SAM2_TEST, seed=1), image_size=64, device="cpu")
    with pytest.raises(RuntimeError, match="set_image"):
        pred.predict(box=BOXES[0])


def test_tree_of_the_jax_init_loads():
    """The JAX model's own init has no mask-prompt encoder (no image prompt
    reaches it); the port takes that tree and gives the JAX masks."""
    import jax

    from freepose_tpu.models.sam2.model import Sam2ImageModel as JaxModel

    tree = jax.jit(lambda key: JaxModel(JAX_SAM2_TEST).init(key, jnp.zeros((1, 3, 64, 64))))(
        jax.random.PRNGKey(0))["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    assert "mask_embed" not in tree["prompt_encoder"]
    image = (np.random.default_rng(2).random((64, 64, 3)) * 255).astype(np.uint8)
    jax_pred, ours = JaxPredictor(JAX_SAM2_TEST, tree, image_size=64), \
        Sam2ImagePredictor(SAM2_TEST, tree, image_size=64, device="cpu")
    jax_pred.set_image(jnp.asarray(image))
    ours.set_image(image)
    _assert_same(ours.predict(box=BOXES[:2], multimask_output=False),
                 jax_pred.predict(box=BOXES[:2], multimask_output=False))


def test_tracing_sees_the_image_path():
    """Inside timing.tracing(): one image counted, its embedding and its
    prediction as spans, the fetch as a wait nested in the prediction; the
    masks are those of an untraced call."""
    from freepose_tpu_torch.utils import timing

    pred = Sam2ImagePredictor(SAM2_TEST, random_sam2_image_params(SAM2_TEST, seed=3), image_size=64, device="cpu")
    image = (np.random.default_rng(3).random((48, 80, 3)) * 255).astype(np.uint8)
    pred.set_image(image)
    plain = pred.predict(box=BOXES, multimask_output=False)
    with timing.tracing():
        pred.set_image(image)
        traced = pred.predict(box=BOXES, multimask_output=False)
        records, counts = list(timing.records), dict(timing.counts)
    names = [(name, parent) for name, parent, _, _ in records]
    assert counts.get("sam2.images") == 1
    assert ("sam2.image.embed", None) in names and ("sam2.image.predict", None) in names
    assert ("wait.sam2.image_masks", "sam2.image.predict") in names
    for a, b in zip(traced, plain):
        np.testing.assert_array_equal(a, b)
