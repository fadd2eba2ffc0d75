"""Faults planted in the program for the BOP cells, where an answer or a
state is produced; each must make `correct` false. A fault is planted in a
cell already set up (`FAULTS[name](cell)`, a context manager), on the
program's modules only, so the reference the check runs is untouched; the
caller drops the detector's graphs before and after, so that its replays
hold the fault only while it is planted (readings_bop.passes):

  * gdino_offsets_dropped: every deformable attention samples at its
    reference points (the offset projection's output zeroed);
  * gdino_levels_swapped: every deformable attention's weights of feature
    levels 0 and 1 exchanged;
  * gdino_fusion_skipped: the encoder's vision-text fusion adds nothing;
  * swin_shift_mask_dropped: shifted windows attend across the regions the
    mask keeps apart;
  * gdino_select_off_by_one: the two-stage selection takes the positions of
    ranks 2..901;
  * gdino_refine_skipped: the third decoder layer leaves the boxes as they
    were;
  * sam2_lowest_iou: SAM2's image masks are the multimask candidate of
    lowest predicted IoU, in place of the single mask or its fallback;
  * sam2_boxes_unscaled: SAM2's box prompts reach the decoder in the
    image's pixels, not scaled to the model's 1024² frame;
  * retrieval_cls_token: retrieval takes the crop's cls token, not the FFA
    of its masked patches;
  * retrieval_second_row: retrieval puts each proposal's second-best row
    first;
  * stale_pack (bop_new_meshes): the template bank hands back a pack built
    before, for another mesh;
  * shifted_crop (bop_new_meshes): the pose stage crops each proposal 8
    pixels to the right;
  * coarse_worst_view (bop_new_meshes): the coarse pose is the view scored
    last, with the best view's score;
  * lift_off (bop_new_meshes): the lifted translation lies 5% too far."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _hooks(modules, fn, prepend: bool = False):
    handles = [m.register_forward_hook(fn, prepend=prepend) for m in modules]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _deform_modules(cell):
    from freepose_tpu_torch.models.grounding_dino import MultiScaleDeformableAttention

    return [m for m in cell.detector.model.modules() if isinstance(m, MultiScaleDeformableAttention)]


def gdino_offsets_dropped(cell):
    return _hooks([m.sampling_offsets for m in _deform_modules(cell)], lambda _m, _i, out: torch.zeros_like(out))


def gdino_levels_swapped(cell):
    mods = _deform_modules(cell)
    shape = {m.attention_weights: (m.num_heads, m.num_levels, m.num_points) for m in mods}

    def swap(module, _inputs, out):
        nh, nl, npts = shape[module]
        w = out.reshape(*out.shape[:-1], nh, nl, npts)
        return torch.cat([w[..., 1:2, :], w[..., 0:1, :], w[..., 2:, :]], dim=-2).reshape(out.shape)
    return _hooks(list(shape), swap)


def gdino_fusion_skipped(cell):
    model = cell.detector.model
    mods = [model.get_submodule(f"enc{i}").fusion_attn for i in range(model.config.encoder_layers)]
    return _hooks(mods, lambda _m, _i, out: tuple(torch.zeros_like(o) for o in out))


@contextlib.contextmanager
def swin_shift_mask_dropped(cell):
    from freepose_tpu_torch.models import swin

    real = swin._window_tables

    def tables(*args, **kwargs):
        idx, mask = real(*args, **kwargs)
        return idx, None if mask is None else torch.zeros_like(mask)

    swin._window_tables = tables
    try:
        yield
    finally:
        swin._window_tables = real


def gdino_select_off_by_one(cell):
    """A hook ahead of the cell's own on the selection, so that the cell
    records the positions the fault selects."""
    from freepose_tpu_torch.ops.knn import topk_lowest_index

    def shifted(module, inputs, _output):
        values, idx = topk_lowest_index(inputs[0], module.k + 1)
        return values[..., 1:], idx[..., 1:]
    return _hooks([cell.detector.model.query_select], shifted, prepend=True)


def gdino_refine_skipped(cell):
    model = cell.detector.model
    layer = min(2, model.config.decoder_layers - 2)
    return _hooks([model.get_submodule(f"dec_bbox{layer}")], lambda _m, _i, out: torch.zeros_like(out))


@contextlib.contextmanager
def _retrieval(wrap):
    from freepose_tpu_torch.scripts import extract_proposals_ground

    real = extract_proposals_ground.retrieve_topk
    extract_proposals_ground.retrieve_topk = wrap(real)
    try:
        yield
    finally:
        extract_proposals_ground.retrieve_topk = real


def retrieval_cls_token(cell):
    def wrap(real):
        def cls_token(*args, **kwargs):
            return real(*args, **dict(kwargs, feature_type="cls"))
        return cls_token
    return _retrieval(wrap)


@contextlib.contextmanager
def sam2_lowest_iou(cell):
    predictor = cell.predictor
    real = predictor._decode

    def lowest(point_coords, point_labels, box, multimask_output):
        masks, iou = real(point_coords, point_labels, box, True)
        j = iou.argmin(dim=-1)
        rows = torch.arange(len(j), device=j.device)
        return masks[rows, j][:, None], iou[rows, j][:, None]

    predictor._decode = lowest
    try:
        yield
    finally:
        del predictor._decode


@contextlib.contextmanager
def sam2_boxes_unscaled(cell):
    predictor = cell.predictor
    real = predictor._scale_prompts

    def unscaled(point_coords, point_labels, box):
        pts, labels, _ = real(point_coords, point_labels, None)
        b = torch.as_tensor(np.asarray(box), dtype=torch.float32, device=predictor.device)
        return pts, labels, b.reshape(1, -1, 4)

    predictor._scale_prompts = unscaled
    try:
        yield
    finally:
        del predictor._scale_prompts


def retrieval_second_row(cell):
    def wrap(real):
        def second(*args, **kwargs):
            scores, idx, feats = real(*args, **kwargs)
            return scores.roll(-1, dims=1), idx.roll(-1, dims=1), feats
        return second
    return _retrieval(wrap)


@contextlib.contextmanager
def stale_pack(cell):
    """Every pack is another mesh's, built here: mesh 1's for mesh 0, else
    mesh 0's."""
    bank = cell.tbank
    stale = [bank.build_pack("stale0", cell.tri[0]), bank.build_pack("stale1", cell.tri[1])]
    real = bank.get

    def get(name, mesh=None):
        row = int(name.split(".")[0][len("obj"):])
        return stale[1] if row % len(cell.tri) == 0 else stale[0]

    bank.get = get
    try:
        yield
    finally:
        bank.get = real


@contextlib.contextmanager
def shifted_crop(cell):
    from freepose_tpu_torch.scripts import dino_inference

    real = dino_inference.extract_proposals

    def shifted(image, masks, boxes, *args, **kwargs):
        return real(image, masks, boxes + torch.tensor([8.0, 0.0, 8.0, 0.0], device=boxes.device), *args, **kwargs)

    dino_inference.extract_proposals = shifted
    try:
        yield
    finally:
        dino_inference.extract_proposals = real


@contextlib.contextmanager
def _score_and_lift(wrap):
    from freepose_tpu_torch.pipeline import pose_estimator

    real = pose_estimator.score_and_lift
    pose_estimator.score_and_lift = wrap(real)
    try:
        yield
    finally:
        pose_estimator.score_and_lift = real


def coarse_worst_view(cell):
    def wrap(real):
        def worst(feats, *args, **kwargs):
            args = list(args)
            args[8:9] = [feats.shape[0]]  # top_k: every view
            tcos, scores, idx = real(feats, *args, **kwargs)[:3]
            return tcos.flip(0), scores, idx.flip(0)
        return worst
    return _score_and_lift(wrap)


def lift_off(cell):
    def wrap(real):
        def far(*args, **kwargs):
            out = list(real(*args, **kwargs))
            out[0] = out[0].clone()
            out[0][..., :3, 3] *= 1.05
            return tuple(out)
        return far
    return _score_and_lift(wrap)


FAULTS = {f.__name__: f for f in (gdino_offsets_dropped, gdino_levels_swapped, gdino_fusion_skipped,
                                  swin_shift_mask_dropped, gdino_select_off_by_one, gdino_refine_skipped,
                                  sam2_lowest_iou, sam2_boxes_unscaled, retrieval_cls_token, retrieval_second_row,
                                  stale_pack, shifted_crop, coarse_worst_view, lift_off)}
POSE_FAULTS = ("stale_pack", "shifted_crop", "coarse_worst_view", "lift_off")
