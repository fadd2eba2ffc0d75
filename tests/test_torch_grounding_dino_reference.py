"""The port's GroundingDINO against the benchmark's plain reference
(benchmark/reference/grounding_dino.py), fp32 on the CPU, at a tiny width.

One set of seeded weights (benchmark/bop.py: the reference's spec, the
benchmark's weight rules, its fusion and norm scales) loads into both by
name. Tolerances, and why:
  * deformable sampling: 1e-5 (the port gathers a 2x2 quad with the
    attention weight folded into the bilinear sum, the reference calls
    F.grid_sample and weights after; fp32 sums in another order);
  * Swin, the encoder memory, the decoder's hidden states and the logits:
    2e-5 relative to the largest entry (fp32 products and sums in another
    order; 3e-6 read at this size, a norm over a 2x2 map with one channel a
    group amplifying them);
  * boxes 1e-5 (after a sigmoid of O(1) logits);
  * the selection: the same 900 positions' scores (ties broken by index on
    the port's side, by torch.topk on the reference's; with ties the sets
    may differ, their scores may not).
"""
import numpy as np
import pytest
import torch

from benchmark import bop
from benchmark.reference import grounding_dino as R
from freepose_tpu_torch.models import grounding_dino as P
from freepose_tpu_torch.models import swin as port_swin
from freepose_tpu_torch.utils import timing

CFG = {"dtype": "float32", "grounding_dino": {
    "image_size": 64,
    "swin": {"embed_dim": 8, "depths": [1, 1, 2], "num_heads": [1, 2, 4], "window_size": 4, "patch_size": 4,
             "mlp_ratio": 4.0, "out_stages": [1, 2]},
    "text": {"vocab_size": 1100, "hidden_size": 24, "num_layers": 1, "num_heads": 2, "intermediate": 48,
             "max_position": 32, "type_vocab": 2},
    "transformer": {"d_model": 32, "num_feature_levels": 3, "encoder_layers": 1, "decoder_layers": 2,
                    "encoder_heads": 4, "decoder_heads": 4, "encoder_ffn": 64, "decoder_ffn": 64,
                    "encoder_points": 4, "decoder_points": 4, "num_queries": 12, "max_text_len": 16,
                    "pos_temperature": 20.0}}}
IDS = np.array([[101, 103, 1012, 102]])
REL = 2e-5


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    w = bop.gdino_weights(CFG, 7, "cpu", torch.float32)
    ref = bop.reference_gdino(CFG, w, "cpu")
    pcfg = bop.port_gdino_config(CFG, torch.float32)
    port = P.GroundingDino(pcfg).eval()
    port.load_state_dict(bop.port_state(w, pcfg.decoder_layers))
    return port, ref, w


def _close(a, b, rel=REL):
    a, b = a.float(), b.float()
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rel * max(scale, 1.0), (float((a - b).abs().max()), scale)


def _port_inputs(n: int):
    ids = np.repeat(IDS, n, axis=0)
    sa, pos = P.text_token_masks(ids)
    return [torch.as_tensor(a) for a in (ids, sa, pos, np.zeros(ids.shape, bool))]


def _port_forward(port, pixels):
    """The port's outputs and, caught on the way, its encoder memory, its
    selected positions and its last decoder layer's output."""
    seen = {}
    hooks = [getattr(port, f"enc{port.config.encoder_layers - 1}").register_forward_hook(
                 lambda m, i, o: seen.__setitem__("memory", o[0])),
             getattr(port, f"dec{port.config.decoder_layers - 1}").register_forward_hook(
                 lambda m, i, o: seen.__setitem__("hidden", o)),
             port.query_select.register_forward_hook(lambda m, i, o: seen.__setitem__("select", o[1]))]
    try:
        with torch.no_grad():
            logits, boxes = port(pixels, *_port_inputs(pixels.shape[0]))
    finally:
        for h in hooks:
            h.remove()
    return logits, boxes, seen


def test_text_masks_and_prepare_match_the_port():
    for ids in (IDS, np.array([[101, 5, 6, 1012, 7, 1029, 8, 102]])):
        for ours, ref in zip(P.text_token_masks(ids), R.text_masks(ids)):
            np.testing.assert_array_equal(ours, ref)
    img = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (30, 44, 3)).astype(np.uint8))
    torch.testing.assert_close(P.prepare_detection_image(img, 64)[None], R.prepare(img, 64), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_deformable_sampling_matches_grid_sample_with_points_outside(models, ref_dim):
    port, ref, _ = models
    pm, rm = port.enc0.deform_attn, ref.enc0.deform_attn
    g = torch.Generator().manual_seed(ref_dim)
    shapes = [(6, 7), (3, 4), (2, 2)]
    s = sum(h * w for h, w in shapes)
    value = torch.randn(2, s, 32, generator=g)
    query = torch.randn(2, 9, 32, generator=g) * 4.0  # large offsets: many samples fall off the maps
    refs = torch.rand(2, 9, 3, ref_dim, generator=g) * 1.2 - 0.1
    with torch.no_grad():
        locs_off = pm.sampling_offsets(query).abs().max()
        ours = pm(query, value, refs, shapes)
        theirs = rm(query, value, refs, shapes)
    assert float(locs_off) > 1.0
    torch.testing.assert_close(ours, theirs, atol=1e-5, rtol=0)


def test_swin_shifted_windows_on_a_grid_the_window_does_not_divide(models):
    port, ref, _ = models
    pixels = torch.randn(1, 3, 72, 88, generator=torch.Generator().manual_seed(1))  # stage grids 18x22, 9x11, 5x6
    with torch.no_grad():
        ours, theirs = port.backbone(pixels), ref.backbone(pixels)
    assert [o.shape[1:3] for o in ours] == [(9, 11), (5, 6)]
    for a, b in zip(ours, theirs):
        _close(a, b)
    # The shift mask on the padded 20x24 grid: the same regions on both sides.
    np.testing.assert_array_equal(port_swin._shift_attn_mask(20, 24, 4, 2), R.shift_mask(20, 24, 4, 2, "cpu").numpy())


def test_whole_detector_matches_the_reference(models):
    port, ref, _ = models
    img = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (48, 80, 3)).astype(np.uint8))
    pixels = P.prepare_detection_image(img, 64)[None]
    logits, boxes, seen = _port_forward(port, pixels)
    out = ref(R.prepare(img, 64), IDS, follow=seen["select"])
    _close(seen["memory"], out["memory"])
    _close(seen["hidden"], out["hidden"])
    finite = torch.isfinite(out["logits"])
    assert torch.equal(torch.isfinite(logits), finite) and finite.any() and not finite.all()
    _close(logits[finite], out["logits"][finite])
    torch.testing.assert_close(boxes, out["boxes"], atol=1e-5, rtol=0)
    # The port's own selection is the reference's.
    own = out["scores"].gather(1, out["own_select"]).sort(descending=True).values
    picked = out["scores"].gather(1, seen["select"]).sort(descending=True).values
    torch.testing.assert_close(picked, own, atol=1e-5, rtol=0)


def test_tied_selection_takes_the_same_scores(models):
    """A zero enc_output weight gives every valid position the same output,
    so scores tie: the port takes the lowest indices, the reference's topk
    its own; the scores taken are the same, and following the port's
    positions the outputs agree."""
    port, ref, w = models
    tied = dict(w, **{"enc_output.weight": torch.zeros_like(w["enc_output.weight"])})
    ref_t = bop.reference_gdino(CFG, tied, "cpu")
    port_t = P.GroundingDino(port.config).eval()
    port_t.load_state_dict(bop.port_state(tied, port.config.decoder_layers))
    img = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (64, 64, 3)).astype(np.uint8))
    logits, boxes, seen = _port_forward(port_t, P.prepare_detection_image(img, 64)[None])
    out = ref_t(R.prepare(img, 64), IDS, follow=seen["select"])
    sel = seen["select"][0]
    assert torch.equal(sel, torch.sort(sel).values)  # ties to the lowest index
    torch.testing.assert_close(out["scores"].gather(1, seen["select"]), out["scores"].gather(1, out["own_select"]),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(boxes, out["boxes"], atol=1e-5, rtol=0)


def test_spans_and_counters_are_present_and_counted(models):
    port, _, _ = models
    pixels = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    c = port.config
    with timing.tracing(), torch.no_grad():
        port(pixels, *_port_inputs(2))
        names = [r[0] for r in timing.records]
        counts = dict(timing.counts)
    for name in ("gdino.text", "gdino.backbone", "gdino.encoder", "gdino.select", "gdino.decoder"):
        assert names.count(name) == 1, name
    assert names.count("gdino.deform") == c.encoder_layers + c.decoder_layers
    parents = {r[0]: r[1] for r in timing.records if r[0] != "gdino.deform"}
    assert all(parents[n] is None for n in ("gdino.text", "gdino.backbone", "gdino.encoder", "gdino.decoder"))
    assert {r[1] for r in timing.records if r[0] == "gdino.deform"} == {"gdino.encoder", "gdino.decoder"}
    assert counts["gdino.images"] == 2
    assert counts["gdino.tokens"] == 2 * 84  # levels of 8², 4² and 2² at 64²
    assert counts["gdino.queries"] == 2 * c.num_queries
    per = c.encoder_heads * c.num_feature_levels * c.encoder_points
    assert counts["gdino.deform_samples.encoder"] == 2 * 84 * per * c.encoder_layers
    assert counts["gdino.deform_samples.decoder"] == 2 * c.num_queries * per * c.decoder_layers


def test_host_selection_takes_a_threshold_from_the_scores(models):
    port, _, _ = models
    det = P.GroundingDinoDetector.__new__(P.GroundingDinoDetector)
    det.model, det.device, det.image_size, det.tokenizer, det.config = port, torch.device("cpu"), 64, None, \
        port.config
    img = np.random.default_rng(5).integers(0, 256, (48, 80, 3)).astype(np.uint8)
    logits, boxes = det.forward_images([img])
    scores = det.query_scores(logits)[0].numpy()
    with timing.tracing():
        (xyxy, kept), = det.select_boxes(logits, boxes, [img.shape[:2]], lambda s: bop.threshold_between(s, 3))
        waits = [r[0] for r in timing.records]
    assert waits == ["wait.gdino.scores"] and len(kept) == 3
    np.testing.assert_array_equal(np.sort(kept), np.sort(scores)[-3:])
    ref_boxes, ref_scores = det.detect_batch([img], box_threshold=bop.threshold_between(scores, 3))[0]
    np.testing.assert_array_equal(xyxy, ref_boxes)
