"""The image predictor's CUDA graphs (freepose_tpu_torch/models/sam2/
predictor.py: _TrunkGraph, _DecodeGraph, trunk_graph_key, decode_graph_key).

On the CPU, at SAM2_TEST, `capture` is replaced by a stand-in that runs each
part eagerly at every replay, and the path rules are told the predictor runs
on a card; everything else of the graph path runs as on a card: the keys,
the padding to the bucket, the static inputs and the copies of the outputs.
A key's first call runs eagerly, its second captures, later calls replay:
after three images two graphs were captured and a fourth image only
replays. Images of two sizes share the trunk's graph, 4 and 12 boxes the
decode's, and each image's outputs equal the eager decode of its prompts
padded to the bucket. Prompt scaling and the decode replaced on the instance
(as benchmark/faults_bop.py plants its faults) act on a graphed prediction.

Marked `cuda` (skipped without a GPU), the same at the production config
(Hiera-L at 1024², bf16, K2 at d 72) with real captures: the graphed masks
and iou equal the eager ones at the bucket bit for bit, a replayed trunk
counts K2's launches as the eager trunk does, the pyramid is the newest
image's, the seams act on replays, and the automatic mask generator shares the
trunk graph.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from freepose_tpu_torch.models.convert import random_sam2_image_params
from freepose_tpu_torch.models.sam2 import predictor as image_predictor
from freepose_tpu_torch.models.sam2.model import SAM2_TEST
from freepose_tpu_torch.models.sam2.predictor import Sam2ImagePredictor, _decode_masks, pad_prompts, prompt_bucket
from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import Graph, GraphCache

CARD, CPU = torch.device("cuda", 0), torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def _image(seed: int, h: int, w: int, k: int):
    """A seeded uint8 image with k painted rectangles, and their boxes [k, 4]."""
    rng = np.random.default_rng(seed)
    image = (rng.random((h, w, 3)) * 90).astype(np.uint8)
    boxes = []
    for _ in range(k):
        x0, y0 = int(rng.integers(0, w * 3 // 4)), int(rng.integers(0, h * 3 // 4))
        x1, y1 = min(w, x0 + int(rng.integers(w // 12, w // 4))), min(h, y0 + int(rng.integers(h // 12, h // 4)))
        image[y0:y1, x0:x1] = rng.integers(100, 255, 3)
        boxes.append([x0, y0, x1, y1])
    return image, np.asarray(boxes, np.float32)


def _graph_counts() -> tuple[int, int]:
    return timing.counts.get("sam2.image.graph_captures", 0), timing.counts.get("sam2.image.graph_replays", 0)


@torch.inference_mode()
def _eager_at_bucket(pred, image, boxes):
    """The eager trunk and the eager decode of the boxes padded to their
    bucket -> (logits [k, 1, g, g], iou [k, 1]), copies."""
    pred.set_image(image)
    prompts = pred._scale_prompts(None, None, boxes)
    logits, iou = _decode_masks(pred.model, pred._pyramid, pad_prompts(prompts, prompt_bucket(len(boxes))), False)
    return logits[:len(boxes)].clone(), iou[:len(boxes)].clone()


def _unscaled(pred):
    """benchmark/faults_bop.py's `sam2_boxes_unscaled`: box prompts left in
    image pixels."""
    real = pred._scale_prompts

    def unscaled(point_coords, point_labels, box):
        pts, labels, _ = real(point_coords, point_labels, None)
        return pts, labels, torch.as_tensor(np.asarray(box), dtype=torch.float32, device=pred.device).reshape(1, -1, 4)

    return unscaled


def _lowest(pred):
    """benchmark/faults_bop.py's `sam2_lowest_iou`: the candidate of the
    lowest predicted IoU."""
    real = pred._decode

    def lowest(point_coords, point_labels, box, multimask_output):
        masks, iou = real(point_coords, point_labels, box, True)
        j = iou.argmin(dim=-1)
        rows = torch.arange(len(j), device=j.device)
        return masks[rows, j][:, None], iou[rows, j][:, None]

    return lowest


# ---------------------------------------------------------------- the CPU


class _Eager:
    """A stand-in for a captured graph: each replay runs the part."""

    def __init__(self, part):
        self.part = part

    def replay(self):
        self.part()


def _eager_capture(device, warm_up, *parts):
    warm_up()
    return [Graph(_Eager(part), {}) for part in parts]


@contextlib.contextmanager
def _graph_path(pred):
    """The graph path taken on the CPU, its parts run eagerly, with fresh
    graph caches, dropped again at the end."""
    trunk, decode = image_predictor.trunk_graph_key, image_predictor.decode_graph_key
    with pytest.MonkeyPatch.context() as m:
        m.setattr(image_predictor, "capture", _eager_capture)
        m.setattr(image_predictor, "trunk_graph_key", lambda config, device, pixels: trunk(config, CARD, pixels))
        m.setattr(image_predictor, "decode_graph_key", lambda device, prompts, multimask: decode(CARD, prompts,
                                                                                              multimask))
        pred._trunk_graphs, pred._decode_graphs = GraphCache(), GraphCache()
        try:
            yield pred
        finally:
            pred._trunk_graphs, pred._decode_graphs = GraphCache(), GraphCache()


@pytest.fixture(scope="module")
def predictor():
    return Sam2ImagePredictor(SAM2_TEST, random_sam2_image_params(SAM2_TEST, seed=4), image_size=64, device="cpu")


# Images of two sizes and 4..12 boxes: every one keys the one trunk graph
# and the one decode graph (bucket 16).
IMAGES = [(0, 48, 80, 4), (1, 48, 80, 8), (2, 40, 64, 12), (3, 48, 80, 6)]


def test_the_path_rule():
    from freepose_tpu_torch.ops import attention

    pixels = torch.zeros((1, 3, 64, 64))
    boxes = [torch.zeros((1, k, 4)) for k in (1, 4, 12, 16, 17)]
    with torch.inference_mode():
        assert image_predictor.trunk_graph_key(SAM2_TEST, CPU, pixels) is None
        trunk = image_predictor.trunk_graph_key(SAM2_TEST, CARD, pixels)
        assert trunk is not None
        keys = [image_predictor.decode_graph_key(CARD, (None, None, b), False) for b in boxes]
        assert keys[0] == keys[1] == keys[2] == keys[3] != keys[4] and keys[4][0] == 32
        assert image_predictor.decode_graph_key(CARD, (None, None, boxes[1]), True) != keys[1]
        pts, labels = torch.zeros((1, 4, 2, 2)), torch.ones((1, 4, 2), dtype=torch.int64)
        assert image_predictor.decode_graph_key(CARD, (pts, labels, None), False) not in keys
        assert image_predictor.decode_graph_key(CARD, (pts, labels, boxes[1]), False) not in keys
        for none in [(CPU, (None, None, boxes[1])), (CARD, (None, None, None)),
                     (CARD, (None, None, torch.zeros((1, 0, 4))))]:
            assert image_predictor.decode_graph_key(*none, False) is None
        # Another attention function for the trunk's global blocks keys apart.
        cfg = dataclasses.replace(SAM2_TEST, hiera=dataclasses.replace(SAM2_TEST.hiera, use_flash=True))
        kernel = attention.flash_attention_auto
        try:
            flash = image_predictor.trunk_graph_key(cfg, CARD, pixels)
            attention.flash_attention_auto = lambda *args, **kwargs: None
            assert image_predictor.trunk_graph_key(cfg, CARD, pixels) != flash
        finally:
            attention.flash_attention_auto = kernel
    assert image_predictor.trunk_graph_key(SAM2_TEST, CARD, pixels) is None  # outside inference mode
    assert image_predictor.decode_graph_key(CARD, (None, None, boxes[1]), False) is None


def test_graphed_images_equal_the_eager_decode_at_the_bucket(predictor):
    refs = [_eager_at_bucket(predictor, *_image(*spec)) for spec in IMAGES]
    with _graph_path(predictor) as pred, timing.tracing():
        outs, counts = [], []
        for spec in IMAGES:
            image, boxes = _image(*spec)
            pred.set_image(image)
            outs.append(pred._decode(None, None, boxes, False))
            counts.append(_graph_counts())
        assert counts == [(0, 0), (2, 2), (2, 4), (2, 6)]
        assert len(pred._trunk_graphs) == 1 and len(pred._decode_graphs) == 1
        (decode,) = pred._decode_graphs.graphs.values()
        assert all(p is None or p.shape[1] == 16 for p in decode.prompts)
        statics = {id(t) for t in decode.out}
        image, boxes = _image(*IMAGES[-1])
        masks, iou, low = pred.predict(box=boxes, multimask_output=False)
    for (logits, scores), (ref_logits, ref_scores) in zip(outs, refs):
        assert id(logits) not in statics and id(scores) not in statics
        assert torch.equal(logits, ref_logits) and torch.equal(scores, ref_scores)
    np.testing.assert_array_equal(low, refs[-1][0].numpy())
    np.testing.assert_array_equal(iou, refs[-1][1].numpy())
    assert masks.shape == (6, 1, 48, 80) and masks.dtype == bool


def test_the_seams_act_on_a_graphed_prediction(predictor):
    """Prompt scaling and the decode replaced on the instance change a
    graphed prediction (the scaling's fault replays the same graph), and the
    prediction returns once they are lifted."""
    image, boxes = _image(*IMAGES[1])
    with _graph_path(predictor) as pred, timing.tracing():
        for _ in range(2):
            pred.set_image(image)
            sound = pred.predict(box=boxes, multimask_output=False, return_logits=True)
        assert _graph_counts() == (2, 2)
        pred._scale_prompts = _unscaled(pred)
        unscaled = pred.predict(box=boxes, multimask_output=False, return_logits=True)
        assert _graph_counts() == (2, 3)
        del pred._scale_prompts
        pred._decode = _lowest(pred)
        lowest = pred.predict(box=boxes, multimask_output=False, return_logits=True)
        del pred._decode
        again = pred.predict(box=boxes, multimask_output=False, return_logits=True)
    assert np.abs(unscaled[0] - sound[0]).max() > 1e-3
    assert np.abs(lowest[0] - sound[0]).max() > 1e-3 and not np.array_equal(lowest[1], sound[1])
    for a, b in zip(again, sound):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    """The card, with tracing on for the test (launches and graphs are counted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with timing.tracing():
        yield torch.device("cuda")


def _production_predictor(device):
    from freepose_tpu_torch.scripts.common import production_sam2_config

    cfg, size = production_sam2_config(device)
    return Sam2ImagePredictor(cfg, image_size=size, device=device, seed=7)


# 640x480 (BOP's LM-O size) and another size; k = 4, 8, 12, 6: one key each.
CARD_IMAGES = [(10, 480, 640, 4), (11, 480, 640, 8), (12, 540, 720, 12), (13, 480, 640, 6)]


@pytest.mark.cuda
def test_graphed_image_path_equals_eager_on_the_card(cuda, monkeypatch):
    """At the production config: each image's graphed logits and iou equal
    the eager trunk and decode at the bucket bit for bit; after three images
    two graphs were captured and a fourth only replays, counting K2 at d 72
    as the eager trunk does; set_image(A), set_image(B) decodes B."""
    pred = _production_predictor(cuda)
    specs = [_image(*spec) for spec in CARD_IMAGES]
    with monkeypatch.context() as m:
        m.setattr(image_predictor, "trunk_graph_key", lambda *args: None)
        k2 = timing.counts.get("launch.k2.d72", 0)
        refs = [_eager_at_bucket(pred, image, boxes) for image, boxes in specs]
        eager_k2 = (timing.counts.get("launch.k2.d72", 0) - k2) // len(specs)
    assert eager_k2 == len(pred.config.hiera.global_attention_blocks) and _graph_counts() == (0, 0)
    outs, counts = [], []
    for image, boxes in specs:
        k2 = timing.counts.get("launch.k2.d72", 0)
        pred.set_image(image)
        outs.append(pred._decode(None, None, boxes, False))
        counts.append((_graph_counts(), timing.counts.get("launch.k2.d72", 0) - k2))
    torch.cuda.synchronize()
    # The second image captures: its warm-up and its replay both count.
    assert counts == [((0, 0), eager_k2), ((2, 2), 2 * eager_k2), ((2, 4), eager_k2), ((2, 6), eager_k2)]
    assert len(pred._trunk_graphs) == 1 and len(pred._decode_graphs) == 1
    for (logits, iou), (ref_logits, ref_iou) in zip(outs, refs):
        assert torch.equal(logits, ref_logits) and torch.equal(iou, ref_iou)
    (trunk,) = pred._trunk_graphs.graphs.values()
    pred.set_image(specs[0][0])
    pred.set_image(specs[2][0])
    assert pred._pyramid is trunk.pyramid
    masks, iou, low = pred.predict(box=specs[2][1], multimask_output=False)
    assert np.array_equal(low, refs[2][0].float().cpu().numpy())
    assert np.array_equal(iou, refs[2][1].float().cpu().numpy())
    assert masks.shape == (12, 1, 540, 720)
    assert _graph_counts() == (2, 9)


@pytest.mark.cuda
def test_the_seams_act_on_a_graphed_prediction_on_the_card(cuda):
    """Once both graphs replay, benchmark/faults_bop.py's two SAM2 faults,
    planted on the instance, change the prediction, and lifting them gives
    the sound one again."""
    pred = _production_predictor(cuda)
    image, boxes = _image(*CARD_IMAGES[1])
    for _ in range(3):
        pred.set_image(image)
        sound = pred.predict(box=boxes, multimask_output=False, return_logits=True)
    assert _graph_counts() == (2, 4)
    pred._scale_prompts = _unscaled(pred)
    unscaled = pred.predict(box=boxes, multimask_output=False, return_logits=True)
    assert _graph_counts() == (2, 5)
    del pred._scale_prompts
    pred._decode = _lowest(pred)
    lowest = pred.predict(box=boxes, multimask_output=False, return_logits=True)
    del pred._decode
    again = pred.predict(box=boxes, multimask_output=False, return_logits=True)
    assert np.abs(unscaled[0] - sound[0]).max() > 1e-2
    assert np.abs(lowest[0] - sound[0]).max() > 1e-2
    for a, b in zip(again, sound):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_the_automatic_generator_shares_the_trunk_graph_on_the_card(cuda, monkeypatch):
    """Sam2AutomaticMaskGenerator over the whole image and four crops of
    another size: the crops replay the one trunk graph (captured at the
    first crop), the decode stays eager, and the records equal those of
    the eager trunk."""
    from freepose_tpu_torch.models.sam2.automatic import Sam2AutomaticMaskGenerator

    pred = _production_predictor(cuda)
    gen = Sam2AutomaticMaskGenerator(pred, points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
                                     stability_score_thresh=0.0, crop_n_layers=1)
    image, _ = _image(20, 480, 640, 6)
    with monkeypatch.context() as m:
        m.setattr(image_predictor, "trunk_graph_key", lambda *args: None)
        eager = gen.generate(image)
    graphed = gen.generate(image)
    assert _graph_counts() == (1, 4) and len(pred._trunk_graphs) == 1 and len(pred._decode_graphs) == 0
    assert len(graphed) == len(eager) > 0
    for a, b in zip(graphed, eager):
        assert np.array_equal(a["segmentation"], b["segmentation"])
        assert a["predicted_iou"] == b["predicted_iou"] and a["crop_box"] == b["crop_box"]
