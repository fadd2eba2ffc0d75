"""Pose matching and recall scoring (BOP19 protocol).

Equivalents of bop_toolkit's matching + scoring
(bop_toolkit_lib/pose_matching.py:9-161, score.py:12-169) and the custom
eval script's error/threshold sweep (bop_toolkit/scripts/eval_bop19_pose.py:
19-70): errors {cus, chamfer, chamfer_proj} with correctness thresholds,
average recall = mean over thresholds of matched-GT recall.

A copy of freepose_tpu.evaluation.score (numpy only):
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# BOP19-style threshold sweeps for the repo's custom error set
# (reference eval_bop19_pose.py:19-70).
DEFAULT_ERROR_THRESHOLDS = {
    "cus": np.arange(0.05, 0.51, 0.05),
    "chamfer": np.arange(0.05, 0.51, 0.05),  # relative to object diameter
    "chamfer_proj": np.arange(5, 51, 5),  # pixels
    "mspd": np.arange(5, 51, 5),
    "mssd": np.arange(0.05, 0.51, 0.05),
}


@dataclasses.dataclass
class EstimateErrors:
    """Errors of one estimate against every GT instance of a frame."""

    scene_id: int
    im_id: int
    obj_id: object
    score: float
    errors: dict  # gt_index -> float


def match_poses(
    frame_errors: list[EstimateErrors],
    threshold: float,
    n_gts: int,
    n_top: int = -1,
) -> tuple[list[tuple[int, int]], int]:
    """Greedy matching of estimates to GT instances at one error threshold
    (reference pose_matching.py): estimates sorted by confidence, each takes
    its lowest-error unclaimed GT if the error passes the threshold.

    Returns (matches [(est_idx, gt_idx)], n_gts).
    """
    order = np.argsort([-e.score for e in frame_errors])
    if n_top > 0:
        order = order[:n_top]
    claimed = set()
    matches = []
    for est_idx in order:
        errs = frame_errors[est_idx].errors
        best_gt, best_err = None, np.inf
        for gt_idx, err in errs.items():
            if gt_idx in claimed or err > threshold:
                continue
            if err < best_err:
                best_gt, best_err = gt_idx, err
        if best_gt is not None:
            claimed.add(best_gt)
            matches.append((int(est_idx), int(best_gt)))
    return matches, n_gts


def recall_at_threshold(
    per_frame: list[tuple[list[EstimateErrors], int]], threshold: float
) -> float:
    """Recall over all frames: matched GTs / total GTs."""
    matched = 0
    total = 0
    for frame_errors, n_gts in per_frame:
        m, _ = match_poses(frame_errors, threshold, n_gts)
        matched += len(m)
        total += n_gts
    return matched / total if total else 0.0


def average_recall(
    per_frame: list[tuple[list[EstimateErrors], int]], thresholds: np.ndarray
) -> float:
    return float(np.mean([recall_at_threshold(per_frame, t) for t in thresholds]))


def bop19_average_recalls(
    errors_by_type: dict, thresholds: dict | None = None
) -> dict:
    """errors_by_type: {"cus": per_frame, "chamfer": per_frame, ...} ->
    per-error AR plus the overall mean AR (the headline metric)."""
    thresholds = thresholds or DEFAULT_ERROR_THRESHOLDS
    out = {}
    for err_type, per_frame in errors_by_type.items():
        out[f"AR_{err_type}"] = average_recall(per_frame, np.asarray(thresholds[err_type]))
    out["AR"] = float(np.mean([v for k, v in out.items() if k.startswith("AR_")]))
    return out


# --------------------------------------------------------------------- #
# Reference-exact protocol (freepose's modified bop_toolkit): estimates
# compete for GTs PER OBJECT CLASS within an image (every estimate of the
# image is scored against every GT of the class — retrieved mesh ids carry
# no est<->GT correspondence, eval_calc_errors.py:323-341), matching is
# greedy by confidence with a validity mask over GTs, and recall is the
# split-wide matched/valid-target ratio (score.py:63-120,
# pose_matching.py:9-161).


@dataclasses.dataclass
class ClassErrors:
    """Errors of one image's estimates against one GT class's instances.

    errors: per estimate, {gt_index_in_image -> error} restricted to GTs of
    this class. gt_valid: validity flags for ALL GTs of the image (indices
    match the gt_index keys).
    """

    scene_id: int
    im_id: int
    obj_id: int  # GT object class
    ests: list[EstimateErrors]
    gt_valid: list[bool]
    gt_ids: list[int] | None = None  # this class's GT indices (targets)


def greedy_match(
    ests: list[EstimateErrors],
    threshold: float,
    gt_valid: list[bool] | None = None,
    max_ests: int = 0,
) -> list[tuple[int, int]]:
    """Reference pose_matching.match_poses: estimates sorted by descending
    score (stable — ties keep input order), each takes the lowest-error
    valid unclaimed GT with error strictly below the threshold."""
    order = sorted(range(len(ests)), key=lambda i: ests[i].score, reverse=True)
    if max_ests > 0:
        order = order[:max_ests]
    claimed: set[int] = set()
    matches = []
    for est_idx in order:
        best_gt, best_err = -1, float(threshold)
        for gt_idx, err in ests[est_idx].errors.items():
            if gt_idx in claimed:
                continue
            if gt_valid is not None and not gt_valid[gt_idx]:
                continue
            if err < best_err:
                best_gt, best_err = gt_idx, err
        if best_gt >= 0:
            claimed.add(best_gt)
            matches.append((est_idx, best_gt))
    return matches


def gt_valid_mask(
    gts: list[dict], targets: dict[int, int], visib_fracts: list[float] | None
) -> list[bool]:
    """Validity of an image's GT instances under the BOP19 "k most visible"
    rule (reference eval_calc_scores.py:238-253): for each target class,
    the inst_count most-visible instances are valid. targets: {obj_id ->
    inst_count}; visib_fracts from scene_gt_info (None -> all equally
    visible, ties broken by GT order like np-stable sort)."""
    n = len(gts)
    vis = visib_fracts if visib_fracts is not None else [1.0] * n
    order = sorted(range(n), key=lambda i: vis[i], reverse=True)
    to_add = dict(targets)
    valid = [False] * n
    for gt_id in order:
        obj_id = gts[gt_id]["obj_id"]
        if to_add.get(obj_id, 0) > 0:
            valid[gt_id] = True
            to_add[obj_id] -= 1
    return valid


def localization_recall(
    class_errors: list[ClassErrors], threshold: float
) -> float:
    """Split-wide recall at one threshold: matched valid GTs / valid GTs,
    where matching runs independently per (image, class) (reference
    pose_matching.match_poses_scene + score.calc_localization_scores)."""
    tps = 0
    tars = 0
    for ce in class_errors:
        own = ce.gt_ids if ce.gt_ids is not None else range(len(ce.gt_valid))
        tars += sum(1 for i in own if ce.gt_valid[i])
        tps += len(greedy_match(ce.ests, threshold, ce.gt_valid))
    return tps / tars if tars else 0.0


def bop19_average_recalls_classed(
    errors_by_type: dict[str, list[ClassErrors]],
    thresholds: dict | None = None,
) -> dict:
    """Reference-protocol AR: per error type, mean over the threshold sweep
    of the split-wide per-class recall; overall AR = mean over error types
    (eval_bop19_pose.py:216-256, 318-325)."""
    thresholds = thresholds or DEFAULT_ERROR_THRESHOLDS
    out = {}
    for err_type, ces in errors_by_type.items():
        ths = np.asarray(thresholds[err_type])
        out[f"AR_{err_type}"] = float(
            np.mean([localization_recall(ces, t) for t in ths])
        )
    out["AR"] = float(np.mean([v for k, v in out.items() if k.startswith("AR_")]))
    return out
