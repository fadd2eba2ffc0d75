"""SAM2 mask transforms, the AMG helpers, box NMS and the automatic mask
generator of the PyTorch port vs the JAX package, on the CPU.

- preprocess within 1e-6; postprocess_masks equal to JAX's on both branches
  (the device's connected components and the g++-built union-find of
  ops/cc_native.py), and cc_native equal to the port's device version.
- Every amg.py helper equal to JAX's (stability within 1e-7: the same int
  counts divided in fp32), nms_xyxy's kept indices equal on random boxes
  with planted equal scores.
- Sam2AutomaticMaskGenerator.generate on SAM2_TEST at 64² (a JAX init with a
  mask input, so the mask-prompt encoder exists, converted by
  state_dict_from_jax) in both packages: binary and RLE output, crop
  layers, m2m, min_mask_region_area and the keep filters: the same records
  in the same order, segmentations, areas, boxes, points and crop boxes
  equal, predicted IoU and stability within 1e-4. The filter thresholds
  are set halfway between two candidates' values that lie at least 1e-3
  apart, so no candidate sits within rounding of a threshold; the NMS
  thresholds are the defaults, and the test asserts that no two candidate
  boxes have an IoU within 1e-4 of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.geometry import boxes as jboxes
from freepose_tpu.models.sam2 import amg as jamg
from freepose_tpu.models.sam2 import transforms as jtransforms
from freepose_tpu.ops import cc_native as jcc
from freepose_tpu_torch.geometry.boxes import nms_xyxy
from freepose_tpu_torch.models.sam2 import amg
from freepose_tpu_torch.models.sam2.automatic import Sam2AutomaticMaskGenerator
from freepose_tpu_torch.models.sam2.model import SAM2_TEST
from freepose_tpu_torch.models.sam2.predictor import Sam2ImagePredictor
from freepose_tpu_torch.models.sam2.transforms import postprocess_masks, preprocess
from freepose_tpu_torch.ops import cc_native, raster_native
from freepose_tpu_torch.ops.connected_components import connected_components_batch, remove_small_components


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- transforms

def test_preprocess_matches_jax():
    img = (np.random.default_rng(0).random((30, 50, 3)) * 255).astype(np.uint8)
    for x in (img, img.astype(np.float32) / 255):
        np.testing.assert_allclose(preprocess(torch.as_tensor(x), size=64).numpy(),
                                   np.asarray(jtransforms.preprocess(jnp.asarray(x), size=64)), atol=1e-6)


@pytest.mark.parametrize("use_native", [False, True])
def test_postprocess_masks_matches_jax(use_native):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 24, 24)).astype(np.float32)
    logits[0, 4:20, 4:20] = 5.0
    logits[0, 10:12, 10:12] = -5.0  # a small hole
    for fill in (0, 4, 8):
        ours = postprocess_masks(torch.as_tensor(logits), (48, 56), fill_hole_area=fill, use_native=use_native)
        ref = jtransforms.postprocess_masks(jnp.asarray(logits), (48, 56), fill_hole_area=fill,
                                            use_native=use_native)
        assert ours.dtype == bool and ours.shape == (3, 48, 56)
        np.testing.assert_array_equal(ours, ref)
    assert ours[0, 21, 21]  # the hole is filled


def test_cc_native_matches_the_device_version_and_jax():
    rng = np.random.default_rng(2)
    masks = rng.random((3, 20, 27)) > 0.55
    labels, areas = cc_native.connected_components_batch(masks)
    dlabels, dareas = connected_components_batch(torch.as_tensor(masks))
    np.testing.assert_array_equal(labels, dlabels.numpy())
    np.testing.assert_array_equal(areas, dareas.numpy())
    for fill in (True, False):
        native = cc_native.remove_small_components(masks, 5, fill_holes=fill)
        device = np.stack([remove_small_components(torch.as_tensor(m), 5, fill_holes=fill).numpy() for m in masks])
        np.testing.assert_array_equal(native, device)
        np.testing.assert_array_equal(native, jcc.remove_small_components(masks, 5, fill_holes=fill))


def test_cc_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "connected_components.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cc_native, "SOURCE", bad)
    monkeypatch.setattr(raster_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cc_native.remove_small_components(np.zeros((1, 4, 4), bool), 2)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        postprocess_masks(torch.zeros(1, 8, 8), (8, 8), use_native=True)


# ------------------------------------------------------------- AMG helpers

def test_amg_helpers_match_jax():
    for n in (1, 4, 7):
        np.testing.assert_array_equal(amg.build_point_grid(n), jamg.build_point_grid(n))
    for args in ((32, 2, 2), (9, 1, 3)):
        for a, b in zip(amg.build_all_layer_point_grids(*args), jamg.build_all_layer_point_grids(*args)):
            np.testing.assert_array_equal(a, b)
    for size, layers in (((480, 640), 1), ((40, 56), 2), ((720, 1280), 0)):
        assert amg.generate_crop_boxes(size, layers, 512 / 1500) == jamg.generate_crop_boxes(size, layers, 512 / 1500)
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 90, (12, 4)).astype(np.float32)
    np.testing.assert_array_equal(amg.uncrop_boxes_xyxy(torch.as_tensor(boxes), [10, 5, 90, 70]).numpy(),
                                  np.asarray(jamg.uncrop_boxes_xyxy(jnp.asarray(boxes), [10, 5, 90, 70])))
    np.testing.assert_array_equal(amg.uncrop_points(torch.as_tensor(boxes[:, :2]), [10, 5, 90, 70]).numpy(),
                                  np.asarray(jamg.uncrop_points(jnp.asarray(boxes[:, :2]), [10, 5, 90, 70])))
    logits = rng.normal(size=(2, 3, 16, 20)).astype(np.float32) * 3
    for thr, off in ((0.0, 1.0), (0.5, 0.25)):
        np.testing.assert_allclose(amg.calculate_stability_score(torch.as_tensor(logits), thr, off).numpy(),
                                   np.asarray(jamg.calculate_stability_score(jnp.asarray(logits), thr, off)),
                                   atol=1e-7)
    masks = logits > 2.5
    masks[0, 1] = False  # an empty mask: [0, 0, 0, 0]
    np.testing.assert_array_equal(amg.batched_mask_to_box(torch.as_tensor(masks)).numpy(),
                                  np.asarray(jamg.batched_mask_to_box(jnp.asarray(masks))))
    near = rng.integers(0, 100, (40, 4)).astype(np.float32)
    for atol in (5.0, 20.0):
        np.testing.assert_array_equal(
            amg.is_box_near_crop_edge(torch.as_tensor(near), [10, 5, 90, 70], [0, 0, 100, 80], atol).numpy(),
            jamg.is_box_near_crop_edge(near, [10, 5, 90, 70], [0, 0, 100, 80], atol))


def test_nms_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    for _ in range(5):
        xy = rng.uniform(0, 50, (40, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.uniform(1, 30, (40, 2)).astype(np.float32)], axis=1)
        scores = rng.choice(np.float32([0.2, 0.5, 0.9]), 40)  # ties: the lower index first
        boxes[5] = boxes[3]  # identical boxes of equal score
        scores[5] = scores[3]
        for thr in (0.3, 0.7):
            np.testing.assert_array_equal(nms_xyxy(boxes, scores, thr), jboxes.nms_xyxy(boxes, scores, thr))
    assert nms_xyxy(np.zeros((0, 4)), np.zeros(0), 0.5).shape == (0,)


# ------------------------------------------------------------- generator

def _jax_init(model, with_mask_input: bool) -> dict:
    """The JAX model's own init (under jax.jit), with or without a mask
    input: only with one does the tree hold the mask-prompt encoder."""
    def init(key):
        kw = {"mask_inputs": jnp.zeros((1, 1, 16, 16))} if with_mask_input else {}
        return model.init(key, jnp.zeros((1, 3, 64, 64)), **kw)["params"]

    return jax.tree.map(np.asarray, jax.jit(init)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def predictors():
    from freepose_tpu.models.sam2.model import SAM2_TEST as JAX_SAM2_TEST
    from freepose_tpu.models.sam2.model import Sam2ImageModel as JaxModel
    from freepose_tpu.models.sam2.predictor import Sam2ImagePredictor as JaxPredictor

    params = _jax_init(JaxModel(JAX_SAM2_TEST), with_mask_input=True)
    ours = Sam2ImagePredictor(SAM2_TEST, params, image_size=64, device="cpu")
    assert ours.has_mask_prompt_encoder
    return ours, JaxPredictor(JAX_SAM2_TEST, params, image_size=64)


def _image(seed, hw):
    return (np.random.default_rng(seed).random((*hw, 3)) * 255).astype(np.uint8)


def _box_ious(records):
    b = np.array([[r["bbox"][0], r["bbox"][1], r["bbox"][0] + r["bbox"][2], r["bbox"][1] + r["bbox"][3]]
                  for r in records], np.float32).reshape(-1, 4)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = np.maximum(np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0]), 0)
    ih = np.maximum(np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1]), 0)
    inter = iw * ih
    return inter / np.maximum(area[:, None] + area[None] - inter, 1e-12)


def _assert_same_records(ours, ref, rle: bool):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        if rle:
            assert a["segmentation"] == b["segmentation"]
        else:
            assert a["segmentation"].dtype == bool
            np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        for key in ("area", "bbox", "point_coords", "crop_box"):
            assert a[key] == b[key], key
        assert abs(a["predicted_iou"] - b["predicted_iou"]) <= 1e-4
        assert abs(a["stability_score"] - b["stability_score"]) <= 1e-4


def _unfiltered(pred, **kw):
    return Sam2AutomaticMaskGenerator(pred, pred_iou_thresh=0.0, stability_score_thresh=0.0, **kw)


CASES = {
    "binary": dict(points_per_side=4, points_per_batch=8),
    "rle": dict(points_per_side=3, points_per_batch=4, output_mode="uncompressed_rle"),
    "crop_layers": dict(points_per_side=3, points_per_batch=4, crop_n_layers=1),
    "m2m": dict(points_per_side=3, points_per_batch=4, use_m2m=True),
    "min_region": dict(points_per_side=3, points_per_batch=4, min_mask_region_area=16),
    "single_mask": dict(points_per_side=3, points_per_batch=5, multimask_output=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_jax(predictors, case):
    from freepose_tpu.models.sam2.automatic import Sam2AutomaticMaskGenerator as JaxGenerator

    ours, ref = predictors
    kw = CASES[case]
    image = _image(len(case), (40, 56) if case == "crop_layers" else (48, 72))
    got = _unfiltered(ours, **kw).generate(image)
    want = JaxGenerator(ref, pred_iou_thresh=0.0, stability_score_thresh=0.0, **kw).generate(image)
    _assert_same_records(got, want, rle=kw.get("output_mode") == "uncompressed_rle")
    ious = _box_ious(got)
    assert not (np.abs(ious - 0.7) <= 1e-4).any()  # no pair within rounding of the NMS threshold


def test_generate_keep_filters_match_jax(predictors):
    """The IoU and stability filters at thresholds halfway between two
    candidates' values (at least 1e-3 apart), from a first unfiltered run."""
    from freepose_tpu.models.sam2.automatic import Sam2AutomaticMaskGenerator as JaxGenerator

    ours, ref = predictors
    image = _image(6, (48, 48))
    kw = dict(points_per_side=4, points_per_batch=8, box_nms_thresh=1.0)
    every = _unfiltered(ours, **kw).generate(image)

    def halfway(values):
        v = np.sort(np.unique(np.round(values, 6)))
        gaps = [(b - a, (a + b) / 2) for a, b in zip(v[:-1], v[1:]) if b - a >= 1e-3]
        return gaps[len(gaps) // 2][1]

    iou_thr = float(halfway([r["predicted_iou"] for r in every]))
    stab_thr = float(halfway([r["stability_score"] for r in every if r["predicted_iou"] > iou_thr]))
    got = Sam2AutomaticMaskGenerator(ours, pred_iou_thresh=iou_thr, stability_score_thresh=stab_thr, **kw
                                     ).generate(image)
    want = JaxGenerator(ref, pred_iou_thresh=iou_thr, stability_score_thresh=stab_thr, **kw).generate(image)
    _assert_same_records(got, want, rle=False)
    assert len(got) < len(every)
    assert all(r["predicted_iou"] > iou_thr and r["stability_score"] >= stab_thr for r in got)


def test_m2m_needs_the_mask_prompt_encoder(predictors):
    """A tree without the mask-prompt encoder (the JAX init's without a mask
    input) loads, but m2m refuses it."""
    params = predictors[1].params
    params = {**params, "prompt_encoder": {k: v for k, v in params["prompt_encoder"].items() if k != "mask_embed"}}
    pred = Sam2ImagePredictor(SAM2_TEST, jax.tree.map(np.asarray, params), image_size=64, device="cpu")
    assert not pred.has_mask_prompt_encoder
    with pytest.raises(ValueError, match="mask-prompt encoder"):
        Sam2AutomaticMaskGenerator(pred, use_m2m=True)
    with pytest.raises(ValueError, match="exactly one"):
        Sam2AutomaticMaskGenerator(pred, points_per_side=None)
