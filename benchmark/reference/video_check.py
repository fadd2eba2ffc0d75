"""The comparison that decides `correct` in the video cells.

The program's outputs on one finished video are judged against the
reference, on a sample of its frames and, for the inliers, on all of them:
  * SAM2: the reference tracks the object from the same box prompt through
    frames 0..last sampled frame at float32, taking on every frame the
    candidate mask the program took (sam2_track.py); `sam2_choice_gap` = the
    largest amount by which the reference's own rule stood from that choice
    (sam2_track.choice_gap: predicted IoUs, and on the prompt frame the
    single mask's stability against its threshold), and at each sampled frame
    `sam2_logit_gap` = the largest |logit| of a pixel the program decided
    otherwise than the reference's logits of the same candidate;
  * the crops of `proposals_from_masks_video`: `crop_err` = the largest
    |difference| of a sampled frame's crop from the reference's crop of the
    same frame and mask;
  * the coarse pose of frame 0 and the refined poses of the sampled frames:
    the reference scores the views the program chose among (the 600
    templates, or the fine grid's neighbourhood of the program's previous
    pose, rendered and featurized here) and counts `pose_off_grid`, the
    poses whose rotation is none of those views (an answer the path cannot
    give); of the others it reads `pose_gap` = the best score less the
    score of the view the program chose, `score_err` = |the program's score
    - the reference's score of that view|, and `lift_err` = the largest
    |difference| of the program's translation from the bbox z-lift of that
    view, over the lift's depth;
  * StreamingInliers: the reference's patch cosines of every frame at the
    program's poses (inliers.py); `inliers_rank` = how far the program's
    threshold lies from the top fifth of them, as a share of them
    (inliers.rank_err), and `inliers_gap` = the largest distance from that
    threshold of a cosine whose side a frame's count must have decided
    otherwise (inliers.count_gap).
With `control`, the same numbers are read for the control in the program's
place (reference/control.py: float8 products), on the program's choices and
inputs as a served model's control reads the same tokens: the candidate
mask, the view its own scores put first, and the counts and threshold of
its own cosines."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.reference import inliers, models, pose, sam2_track
from benchmark.reference.control import fp8_products
from benchmark.reference.frozen.camera import default_video_intrinsics

# A pose is a grid view when their rotations lie within this angle: the
# trace formula reads ~0.01 degrees for two equal float32 rotations, and
# neighbouring views of the 20,000-pose grid lie degrees apart.
GRID_MATCH_DEG = 0.5


def _mask_gap(mask: torch.Tensor, logits: torch.Tensor) -> float:
    """The largest |logit| of a pixel whose decision `mask` takes otherwise."""
    wrong = mask != (logits > 0)
    return float(logits.abs()[wrong].max()) if bool(wrong.any()) else 0.0


def sam2_part(cfg: dict, seed: int, video: dict, sample: list[int], prog: dict, device, control: bool):
    """prog: "lows" {t: [g, g] bool} on every frame, "masks" {t: [H, W]
    bool} on the sampled frames."""
    model = models.sam2(cfg, seed, device)
    frames, n = video["frames"], video["frames"].shape[0]
    upto, keep = max(sample), set(sample)
    ref = dict(sam2_track.track(model, frames, video["box0"], n, upto, device, prog["lows"], keep))
    gap = {"program": 0.0}
    choice = {"program": 0.0}
    for t, r in ref.items():
        choice["program"] = max(choice["program"], sam2_track.choice_gap(r, r["chosen"]))
        if t in keep:
            gap["program"] = max(gap["program"], _mask_gap(prog["masks"][t], r["candidates"][r["chosen"]]))
    if control:
        gap["control"] = choice["control"] = 0.0
        with fp8_products():
            for t, c in sam2_track.track(model, frames, video["box0"], n, upto, device, prog["lows"], keep):
                r = ref[t]
                own = sam2_track.own_choice(c)
                choice["control"] = max(choice["control"], sam2_track.choice_gap(r, own))
                if t in keep:
                    gap["control"] = max(gap["control"], _mask_gap(c["candidates"][own] > 0, r["candidates"][own]))
    del model
    return {side: {"sam2_logit_gap": gap[side], "sam2_choice_gap": choice[side]} for side in gap}


def _judge_views(ref_scores: torch.Tensor, chosen: int, dist: float, prog_score: float) -> dict:
    """A pose answer against the reference's scores of the views it was
    chosen among: `pose_off_grid` 1 where its rotation is none of them (an
    answer the path cannot give), else `pose_gap` (the best score less the
    chosen view's) and `score_err` (|its score - the reference's|)."""
    if chosen < 0 or dist > GRID_MATCH_DEG or not bool(torch.isfinite(ref_scores[chosen])):
        return {"pose_off_grid": 1, "pose_gap": 0.0, "score_err": 0.0}
    return {"pose_off_grid": 0, "pose_gap": float(ref_scores.max() - ref_scores[chosen]),
            "score_err": abs(prog_score - float(ref_scores[chosen]))}


def pose_part(cfg: dict, seed: int, video: dict, sample: list[int], prog: dict, mesh, device, control: bool):
    """prog: masks and crops {t: ...} of the sampled frames, poses [T, 4,
    4] and scores [T] (numpy) of every frame."""
    r = cfg["refine"]
    res, layer = r["template_res"], r["feature_layer"]
    vit = models.dinov2(cfg, "dinov2_l", seed, device)
    h, w = video["frames"].shape[1:3]
    k = default_video_intrinsics(w, h, device=device)
    ts = sorted(prog["masks"])
    frames = torch.as_tensor(video["frames"][ts], device=device)
    masks = torch.stack([prog["masks"][t] | video["mask"][t] for t in ts])
    crops, _, bboxes = pose.frame_crops(frames, masks, res, r["bbox_extend"])
    query = models.patch_features(vit, crops, layer)
    sides = {"program": [], "control": []} if control else {"program": []}
    lift_err = 0.0
    poses = torch.as_tensor(prog["poses"], device=device)
    for i, t in enumerate(ts):
        if t == 0:
            cand = torch.arange(r["n_coarse_poses"], device=device)
            grid = pose.grid(r["n_coarse_poses"], device)
            valid = torch.ones(len(cand), dtype=torch.bool, device=device)
        else:
            grid = pose.grid(r["n_fine_poses"], device)
            cand, valid = pose.neighborhood(grid, poses[t - 1, :3, :3], r["neighborhood_deg"], r["n_neighbors"])
        view_crops, stats = pose.render_views(mesh, grid[cand], res)
        feats = models.patch_features(vit, view_crops, layer)
        scores = torch.where(valid, pose.view_scores(feats, query[i]), -torch.inf)
        j, dist = pose.grid_index(grid, poses[t, :3, :3], cand)
        sides["program"].append(_judge_views(scores, j, dist, float(prog["scores"][t])))
        if dist <= GRID_MATCH_DEG:
            t_ref = pose.lift(stats, j, k, bboxes[i], cfg["refine"]["object_scale"])
            lift_err = max(lift_err, float((t_ref - poses[t, :3, 3]).abs().max() / t_ref[2]))
        if control:
            with fp8_products():
                cf = models.patch_features(vit, torch.cat([crops[i:i + 1], view_crops]), layer)
            c_scores = torch.where(valid, pose.view_scores(cf[1:], cf[0]), -torch.inf)
            jc = int(torch.argmax(c_scores))
            sides["control"].append(_judge_views(scores, jc, 0.0, float(c_scores[jc])))
        del view_crops, feats
    del vit
    out = {side: {"pose_off_grid": sum(x["pose_off_grid"] for x in rows),
                  **{key: max(x[key] for x in rows) for key in ("pose_gap", "score_err")}}
           for side, rows in sides.items()}
    out["program"].update(crop_err=float((crops - prog["crops"]).abs().max()), lift_err=lift_err)
    if control:
        # The control crops and lifts as the reference does: no product
        # enters either.
        out["control"].update(crop_err=0.0, lift_err=0.0)
    return out


def inliers_part(cfg: dict, seed: int, video: dict, prog: dict, mesh_np, device, control: bool):
    """prog: poses [T, 4, 4] and inlier counts [T] of every frame, and the
    threshold the counts were taken at."""
    verts, faces, colors = mesh_np
    mesh = (verts * np.float32(cfg["refine"]["object_scale"]), faces, colors)
    h, w = video["frames"].shape[1:3]
    k = default_video_intrinsics(w, h, device=device)
    vit = models.dinov2(cfg, "dinov2_b", seed, device)
    crops, renders, masks = inliers.crops_and_renders(video["frames"], prog["poses"], mesh, k, device)
    conf = inliers.confidences(vit, crops, renders, masks)
    thr = prog["inliers_thr"]
    out = {"program": {"inliers_rank": inliers.rank_err(conf, thr),
                       "inliers_gap": inliers.count_gap(conf, thr, prog["inliers"])}}
    if control:
        with fp8_products():
            c_conf = inliers.confidences(vit, crops, renders, masks)
        c_thr = inliers.threshold(c_conf)
        c_counts = (c_conf > c_thr).sum(dim=(1, 2)).cpu().numpy()
        out["control"] = {"inliers_rank": inliers.rank_err(conf, c_thr),
                          "inliers_gap": inliers.count_gap(conf, c_thr, c_counts)}
    del vit, crops, renders
    return out


def judge(cfg: dict, seed: int, video: dict, sample: list[int], prog: dict, mesh_np, device,
          control: bool = False) -> dict:
    """-> {"program": {number: value}, "control": {...} (with control),
    "info": {...}}. mesh_np: the mesh's (vertices, faces, colours) as
    numpy. Runs at float32 with TF32 off; restores the settings."""
    mesh = tuple(torch.as_tensor(a, device=device) for a in mesh_np)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    models.full_fp32()
    try:
        t0 = time.perf_counter()
        s = sam2_part(cfg, seed, video, sample, prog, device, control)
        gc.collect()
        t1 = time.perf_counter()
        p = pose_part(cfg, seed, video, sample, prog, mesh, device, control)
        gc.collect()
        t2 = time.perf_counter()
        q = inliers_part(cfg, seed, video, prog, mesh_np, device, control)
        t3 = time.perf_counter()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out = {side: {**s[side], **p[side], **q[side]} for side in s}
    out["info"] = {"check_s": {"sam2": t1 - t0, "poses": t2 - t1, "inliers": t3 - t2}}
    return out


def sample_frames(seed: int, n_frames: int, k: int) -> list[int]:
    """k frames of a video drawn from the seed: the first, the last and
    k - 2 between."""
    rng = np.random.default_rng(seed)
    mid = rng.choice(np.arange(1, n_frames - 1), size=max(0, min(k - 2, n_frames - 2)), replace=False)
    return sorted({0, n_frames - 1, *(int(x) for x in mid)})
