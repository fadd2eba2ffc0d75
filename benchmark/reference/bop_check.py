"""The comparison that decides `correct` in the BOP cells.

One finished image, drawn from the seed among the first the window caught,
is judged against the plain float32 reference (TF32 off):
  * GroundingDINO-B (grounding_dino.py), fed the program's 900 selected
    positions: `gdino_memory_err`, the largest distance between unit
    encoder-output vectors at every position of every level;
    `gdino_select_gap`, the larger of the largest amount by which the
    reference's score of the position the program put at a rank lies below
    the reference's own score of that rank (0 where both order alike), and
    the largest distance from the reference's boundary (midway between its
    900th and 901st scores) of a position one side selected and the other
    did not; `gdino_hidden_err`, the
    same distance as the memory's between the last decoder layer's outputs
    at the queries the program kept; `gdino_box_err`, the largest box
    difference there (pixels of the image); `gdino_keep_gap`, the largest
    distance from the image's threshold of a reference query score whose
    side the program decided otherwise;
  * SAM2's image masks: per detected box the reference decodes every
    candidate (the single mask first) and takes the one the program's mask
    contradicts least; `sam2_logit_gap` = the largest |logit| of a pixel
    the program decided otherwise, `sam2_choice_gap` = how near the
    decoder's own rule (the single mask where stable, else the best
    predicted IoU) came to that candidate (sam2_track.choice_gap);
  * retrieval: the reference's DINOv2-L FFA features of the kept
    proposals' crops; `retrieval_feat_err` = the largest distance from the
    program's unit features, `retrieval_gap` = the reference's best bank
    score less its score of the row the program retrieved first;
  * with poses (the `bop_new_meshes` traffic), of the image's first proposal: `crop_err`
    (the program's query crop against the reference's), `pack_feat_err` (the
    largest distance between unit patch features of sampled views of the
    pack the program built in the window and the reference's renders of
    them) and the coarse pose numbers of video_check (`pose_off_grid`,
    `pose_gap`, `score_err`, `lift_err`) over the 600 views.
With `control`, the same numbers of the control (reference/control.py:
float8 products) in the program's place, on the program's inputs and
positions, with its own choices (its order of the positions, the queries
its scores keep at the threshold, its candidate masks, its retrieved row,
its best view)."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import bop, configs_build, synth, weights
from benchmark.reference import grounding_dino as ref_gd
from benchmark.reference import models, pose, sam2_track, video_check
from benchmark.reference.control import fp8_products
from benchmark.reference.frozen.crop import crop_resize_pad
from benchmark.reference.frozen.dinov2 import normalize_images, split_tokens
from benchmark.reference.frozen.sam2.model import Sam2ImageModel


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def _dist(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float(torch.linalg.norm(_unit(a) - _unit(b), dim=-1).max())


# ------------------------------------------------------------------ detector
def _detector_numbers(side: dict, ref: dict, select: torch.Tensor, thr: float, hw) -> dict:
    """side: "memory", "hidden" [Q, D], "scores" [Q] (query scores),
    "boxes" [Q, 4]; `select` [Q] the positions the side put at each rank."""
    h, w = hw
    q = select.shape[0]
    ranked = ref["scores"].sort(descending=True)
    own = ranked.values[:q]
    order = float((own - ref["scores"][select.long()]).clamp(min=0).max())
    # Positions one side takes and the other does not, by their distance
    # from the reference's boundary between ranks q and q + 1.
    chosen = torch.zeros_like(ref["scores"], dtype=torch.bool)
    chosen[select.long()] = True
    refs = torch.zeros_like(chosen)
    refs[ranked.indices[:q]] = True
    boundary = (ranked.values[q - 1] + ranked.values[q]) / 2 if q < len(ranked.values) else ranked.values[-1]
    differ = chosen != refs
    member = float((ref["scores"][differ] - boundary).abs().max()) if bool(differ.any()) else 0.0
    select_gap = max(order, member)
    kept = side["scores"] > thr
    ref_q = ref["query_scores"]
    differ = kept != (ref_q > thr)
    keep_gap = float((ref_q[differ] - thr).abs().max()) if bool(differ.any()) else 0.0
    box = (ref_gd.xyxy(side["boxes"][kept].float(), w, h) - ref_gd.xyxy(ref["boxes"][kept], w, h)).abs()
    return {"gdino_memory_err": _dist(side["memory"], ref["memory"]), "gdino_select_gap": select_gap,
            "gdino_hidden_err": _dist(side["hidden"][kept], ref["hidden"][kept]),
            "gdino_box_err": float(box.max()) if box.numel() else 0.0, "gdino_keep_gap": keep_gap}


def detector_part(cfg: dict, w: dict, image: np.ndarray, cap: dict, device, control: bool) -> dict:
    g = cfg["grounding_dino"]
    model = bop.reference_gdino(cfg, w, device)
    pixels = ref_gd.prepare(torch.as_tensor(image, device=device), g["image_size"])
    ids = np.asarray([ref_gd.PLACEHOLDER_IDS])
    select = cap["select"][0]

    def view(out):
        return {"memory": out["memory"][0], "hidden": out["hidden"][0], "boxes": out["boxes"][0],
                "scores": out["scores"][0], "query_scores": ref_gd.query_scores(out["logits"][0])}

    ref = view(model(pixels, ids, follow=select[None]))
    prog = {"memory": cap["memory"][0], "hidden": cap["hidden"][0], "boxes": cap["boxes"][0],
            "scores": ref_gd.query_scores(cap["logits"][0].float())}
    out = {"program": _detector_numbers(prog, ref, select, cap["thr"], image.shape[:2])}
    if control:
        with fp8_products():
            c_out = model(pixels, ids, follow=select[None])
            c_own = model(pixels, ids)["own_select"][0]
        c = view(c_out)
        c["scores"] = c.pop("query_scores")
        out["control"] = _detector_numbers(c, ref, c_own, cap["thr"], image.shape[:2])
    del model
    return out


# ------------------------------------------------------------------ SAM2
def sam2_image_model(cfg: dict, seed: int, device) -> Sam2ImageModel:
    model = Sam2ImageModel(configs_build.sam2_image_config(cfg, configs_build.FROZEN, torch.float32, False))
    model = model.to(device).eval()
    weights.load_into(model, weights.make_weights(bop.spec_sam2_image(cfg), synth.sub_seed(seed, "sam2_image"),
                                                  device, configs_build.served_dtype(cfg)))
    return model


@torch.inference_mode()
def _decode(model, image: np.ndarray, boxes: np.ndarray, device):
    """Every candidate's logits [N, M, H, W] at the image's size, the low-res
    single masks [N, g, g] and the predicted IoUs [N, M]."""
    size = model.config.prompt.image_size
    h, w = image.shape[:2]
    pyramid, _ = model.embed_image(sam2_track.prepare(torch.as_tensor(image, device=device), size))
    b = torch.as_tensor(np.asarray(boxes, np.float32), device=device) * torch.tensor(
        [size / w, size / h, size / w, size / h], device=device)
    low, iou, _, _ = model.decode_masks(pyramid, boxes=b[None], every_mask=True)
    full = F.interpolate(low[0].float(), size=(h, w), mode="bilinear", align_corners=False)
    return full, low[0, :, 0].float(), iou[0].float()


def sam2_part(cfg: dict, seed: int, image: np.ndarray, cap: dict, device, control: bool) -> dict:
    model = sam2_image_model(cfg, seed, device)
    boxes, masks = cap["tel"]["boxes"], cap["sam2_masks"]
    decoder = model.decoder
    full, single, iou = _decode(model, image, boxes, device)
    recs = [{"stability": float(decoder._stability(single[n])), "thresh": decoder.cfg.stability_thresh,
             "iou": iou[n]} for n in range(len(boxes))]
    prog_masks = torch.as_tensor(np.asarray(masks), device=device)
    gap = choice = 0.0
    for n, rec in enumerate(recs):
        j = sam2_track.nearest_candidate(prog_masks[n], full[n])
        gap = max(gap, video_check._mask_gap(prog_masks[n], full[n, j]))
        choice = max(choice, sam2_track.choice_gap(rec, j))
    out = {"program": {"sam2_logit_gap": gap, "sam2_choice_gap": choice}}
    if control:
        with fp8_products():
            c_full, c_single, c_iou = _decode(model, image, boxes, device)
        gap = choice = 0.0
        for n, rec in enumerate(recs):
            own = sam2_track.own_choice({"stability": float(decoder._stability(c_single[n])),
                                         "thresh": rec["thresh"], "iou": c_iou[n]})
            gap = max(gap, video_check._mask_gap(c_full[n, own] > 0, full[n, own]))
            choice = max(choice, sam2_track.choice_gap(rec, own))
        out["control"] = {"sam2_logit_gap": gap, "sam2_choice_gap": choice}
    del model
    return out


# ------------------------------------------------------------------ retrieval
def _masked_crops(image: np.ndarray, masks: np.ndarray, boxes: np.ndarray, target: int, extend: float, device):
    """The masked RGB in [0, 1] cropped square around each box -> (crops [N,
    3, T, T], mask crops [N, T, T] bool)."""
    img = torch.as_tensor(image, device=device).float().permute(2, 0, 1) / 255.0
    m = torch.as_tensor(np.asarray(masks), device=device)
    b = torch.as_tensor(np.asarray(boxes, np.float32), device=device)
    rgb = torch.where(m[:, None], img[None], torch.zeros((), device=device))
    crops = crop_resize_pad(rgb, b, target, extend=extend)
    return crops, crop_resize_pad(m[:, None].float(), b, target, extend=extend)[:, 0] > 0.5


@torch.inference_mode()
def _ffa(vit, crops: torch.Tensor, masks: torch.Tensor, layer: int) -> torch.Tensor:
    """Foreground-feature averaging: the mean of the raw patch tokens under
    the mask (area-pooled to the patch grid, > 0; the whole grid where it
    vanishes), unit length."""
    tokens = vit(normalize_images(crops.float()), layer=layer)
    patch = split_tokens(tokens, vit.config.num_registers)["patch"].float()
    g = int(round(patch.shape[1] ** 0.5))
    area = F.adaptive_avg_pool2d(masks[:, None].float(), (g, g))[:, 0] > 0
    m = area.reshape(len(crops), g * g, 1).float()
    pooled = torch.where(m.sum(1) > 0, (patch * m).sum(1) / m.sum(1).clamp(min=1.0), patch.mean(1))
    return _unit(pooled)


def retrieval_part(cfg: dict, seed: int, image: np.ndarray, cap: dict, bank: torch.Tensor, device,
                   control: bool) -> dict:
    ret = cfg["retrieval"]
    tel = cap["tel"]
    keep = tel["keep"]
    masks, boxes = np.asarray(tel["masks"])[keep], np.asarray(tel["boxes"])[keep]
    crops, mcrops = _masked_crops(image, masks, boxes, ret["crop"], ret["bbox_extend"], device)
    vit = models.dinov2(cfg, "dinov2_l", seed, device)
    ref = _ffa(vit, crops, mcrops, ret["feature_layer"])
    scores = ref @ bank.float().T
    best = scores.max(dim=1).values

    def gap(rows):
        return float((best - scores.gather(1, rows[:, None].long())[:, 0]).max())

    prog_rows = torch.as_tensor(np.asarray(tel["indices"].cpu() if torch.is_tensor(tel["indices"])
                                           else tel["indices"])[:, 0], device=device)
    out = {"program": {"retrieval_gap": gap(prog_rows), "retrieval_feat_err": _dist(tel["feats"], ref)}}
    if control:
        with fp8_products():
            c = _ffa(vit, crops, mcrops, ret["feature_layer"])
        out["control"] = {"retrieval_gap": gap((c @ bank.float().T).argmax(dim=1)), "retrieval_feat_err": _dist(c, ref)}
    del vit
    return out


# ------------------------------------------------------------------ poses
def pose_part(cfg: dict, seed: int, image: np.ndarray, rec: dict, meshes: list, device, control: bool) -> dict:
    """The image's first proposal: its query crop, the sampled views of the
    pack built for it, its coarse pose over the 600 views."""
    p = cfg["pose"]
    cap, tel = rec["cap"], rec["cap"]["tel"]
    j0 = tel["keep"][0]
    box = np.trunc(np.asarray(tel["boxes"][j0], np.float64)).astype(np.float32)  # the JSON's integer box
    crop, _ = _masked_crops(image, np.asarray(tel["masks"])[j0:j0 + 1], box[None], p["template_res"],
                            p["bbox_extend"], device)
    vit = models.dinov2(cfg, "dinov2_l", seed, device)
    layer = p["feature_layer"]
    query = models.patch_features(vit, crop, layer)[0]
    pack = cap["pack"]
    verts, faces, colors = meshes[pack["row"] % len(meshes)]
    mesh = tuple(torch.as_tensor(a, device=device) for a in (verts, faces, colors))
    grid = pose.grid(p["n_coarse_poses"], device)
    view_crops, stats = pose.render_views(mesh, grid, p["template_res"])
    feats = models.patch_features(vit, view_crops, layer)
    scores = pose.view_scores(feats, query)
    result = rec["poses"][0]
    j, dist = pose.grid_index(grid, torch.as_tensor(result.R, dtype=torch.float32, device=device),
                              torch.arange(len(grid), device=device))
    views = torch.as_tensor(pack["views"], device=device, dtype=torch.long)
    prog = video_check._judge_views(scores, j, dist, float(result.score))
    sc = cfg["scene"]
    k = torch.tensor([[sc["intrinsics"][0], 0, sc["intrinsics"][2]], [0, sc["intrinsics"][1], sc["intrinsics"][3]],
                      [0, 0, 1]], dtype=torch.float32, device=device)
    lift_err = 0.0
    if dist <= video_check.GRID_MATCH_DEG:
        t_ref = pose.lift(stats, j, k, torch.as_tensor(box, device=device), result.scale)
        t_prog = torch.as_tensor(result.t, dtype=torch.float32, device=device)
        lift_err = float((t_ref - t_prog).abs().max() / t_ref[2])
    prog.update(crop_err=float((cap["query_crops"][0].float() - crop[0]).abs().max()), lift_err=lift_err,
                pack_feat_err=_dist(pack["feats"].reshape(-1, pack["feats"].shape[-1]),
                                    feats[views].reshape(-1, feats.shape[-1])))
    out = {"program": prog}
    if control:
        with fp8_products():
            cq = models.patch_features(vit, crop, layer)[0]
            cf = models.patch_features(vit, view_crops, layer)
        c_scores = pose.view_scores(cf, cq)
        jc = int(torch.argmax(c_scores))
        c = video_check._judge_views(scores, jc, 0.0, float(c_scores[jc]))
        c.update(crop_err=0.0, lift_err=0.0, pack_feat_err=_dist(cf[views].reshape(-1, cf.shape[-1]),
                                                                  feats[views].reshape(-1, feats.shape[-1])))
        out["control"] = c
    del vit, view_crops, feats
    return out


def judge(cfg: dict, seed: int, gd_weights: dict, entry: dict, rec: dict, bank: torch.Tensor, meshes: list,
          device, control: bool = False) -> dict:
    """-> {"program": {number: value}, "control": {...} (with control),
    "info": {...}}. Runs at float32 with TF32 off; restores the settings."""
    image, cap = entry["image"], rec["cap"]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    models.full_fp32()
    parts, times = [], {}
    try:
        for name, fn in (("detector", lambda: detector_part(cfg, gd_weights, image, cap, device, control)),
                         ("sam2", lambda: sam2_part(cfg, seed, image, cap, device, control)),
                         ("retrieval", lambda: retrieval_part(cfg, seed, image, cap, bank, device, control)),
                         *([("poses", lambda: pose_part(cfg, seed, image, rec, meshes, device, control))]
                           if rec.get("poses") else [])):
            t0 = time.perf_counter()
            parts.append(fn())
            times[name] = time.perf_counter() - t0
            gc.collect()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out = {side: {k: v for part in parts for k, v in part[side].items()} for side in parts[0]}
    out["info"] = {"check_s": times, "checked_image": rec["index"], "k": rec["k"], "kept": rec["kept"],
                   "threshold": cap["thr"]}
    return out
