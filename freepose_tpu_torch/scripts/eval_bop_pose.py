"""BOP-style pose evaluation (freepose's modified protocol).

Counterpart of the JAX package's scripts/eval_bop_pose.py, with the same
arguments (plus --device) and the same score JSON: the reference's modified
bop_toolkit script (bop_toolkit/scripts/eval_bop19_pose.py) with its exact
association semantics. Retrieved mesh ids carry no est<->GT correspondence,
so EVERY estimate of an image competes for the GTs of EACH target object
class (eval_calc_errors.py:323-341); sphere-overlap prefilters are bypassed
(:394-414); errors are computed raw and normalized at scoring time (chamfer
by the GT class diameter, chamfer_proj by 640/im_width,
eval_calc_scores.py:54-57, 261-273); recall is the split-wide
matched/valid-target ratio with the "inst_count most visible" GT validity
rule (eval_calc_scores.py:238-253, score.py:63-120).

Errors run on the device in float32 with TF32 off (chamfer nearest
neighbours by the expansion trick; `cus`, `vsd` render through
evaluation/pose_error.py:MaskRenderer, on the card kernel K1, one pose per
render, the estimate rendered again for every GT instance as in the JAX
script). With --device cpu the renders go through the native C++
rasterizer, as the JAX script's do on a host with no accelerator.

Usage: python -m freepose_tpu_torch.scripts.eval_bop_pose --results est.csv \
         --dataset BOP_DIR --models-dir MODELS --inference-mesh-dir MESHES \
         [--errors cus chamfer chamfer_proj vsd mssd mspd] [--out scores.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from freepose_tpu_torch.datasets.bop import BOPDataset
from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.evaluation import pose_error as pe
from freepose_tpu_torch.evaluation.score import (
    DEFAULT_ERROR_THRESHOLDS,
    ClassErrors,
    EstimateErrors,
    bop19_average_recalls_classed,
    gt_valid_mask,
)
from freepose_tpu_torch.io.bop_csv import check_bop_results, read_results_csv
from freepose_tpu_torch.scripts.common import add_device_arg, add_shard_args, full_fp32, get_shard


def _load_mesh_any(path_obj: Path, path_ply: Path):
    from freepose_tpu_torch.io.mesh import load_obj, load_ply

    if path_ply.exists():
        return load_ply(path_ply)
    if path_obj.exists():
        return load_obj(path_obj)
    raise FileNotFoundError(f"{path_obj} / {path_ply}")


def _true_diameter(verts: np.ndarray) -> float:
    """Max pairwise vertex distance (the models_info 'diameter' definition).
    The diameter is realized on the convex hull, so reducing to hull vertices
    is EXACT (unlike strided subsampling, which can underestimate it)."""
    v = np.asarray(verts, np.float64)
    if len(v) > 2000:
        from scipy.spatial import ConvexHull, QhullError

        try:
            v = v[ConvexHull(v).vertices]
        except QhullError:  # degenerate (coplanar) inputs: keep all vertices
            pass
    if len(v) > 4000:  # pathological hulls: chunk the pairwise pass
        best = 0.0
        for i in range(0, len(v), 2000):
            d2 = ((v[i : i + 2000, None] - v[None]) ** 2).sum(-1)
            best = max(best, float(d2.max()))
        return float(np.sqrt(best))
    d2 = ((v[:, None] - v[None]) ** 2).sum(-1)
    return float(np.sqrt(d2.max()))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", required=True, help="BOP result CSV (t in mm)")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--models-dir", required=True, help="GT models (obj_<id>.ply)")
    ap.add_argument("--inference-mesh-dir", required=True, help="retrieved mesh cache")
    ap.add_argument("--errors", nargs="+", default=["cus", "chamfer", "chamfer_proj"],
                    help="any of cus chamfer chamfer_proj vsd mssd mspd")
    ap.add_argument("--n-points", type=int, default=2000, help="surface samples per mesh")
    ap.add_argument("--points", choices=["surface", "vertices"], default="vertices",
                    help="mesh point set for distance errors; 'vertices' is "
                    "reference-exact (the toolkit uses raw vertices, "
                    "eval_calc_errors.py:204-207); 'surface' draws one "
                    "fixed-seed area-weighted sample set per mesh")
    ap.add_argument("--targets", default=None,
                    help="test_targets_bop19.json (scene_id/im_id/obj_id/"
                    "inst_count); default = every GT class of every frame")
    ap.add_argument("--models-info", default=None,
                    help="models_info.json for diameters + mssd/mspd symmetries")
    ap.add_argument("--vsd-delta", type=float, default=0.015, help="visibility tolerance (m)")
    ap.add_argument("--out", default=None)
    add_shard_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_fp32()

    ok, msg = check_bop_results(args.results)
    if not ok:  # the reference script aborts on malformed CSVs (inout.py:385-421)
        raise SystemExit(f"results format check failed: {msg}")

    dataset = BOPDataset(args.dataset, args.split)
    results = read_results_csv(args.results, t_scale=1000.0)
    by_frame: dict = defaultdict(list)
    for r in results:
        by_frame[(r.scene_id, r.im_id)].append(r)

    targets_by_frame: dict | None = None
    if args.targets:
        targets_by_frame = defaultdict(dict)
        for t in json.loads(Path(args.targets).read_text()):
            targets_by_frame[(t["scene_id"], t["im_id"])][t["obj_id"]] = t["inst_count"]

    # BOP19 VSD sweeps misalignment tolerances; AR_vsd = mean of the per-tau
    # ARs (reference eval_bop19_pose.py:19-40). Each tau becomes its own
    # error column "vsd:<tau>".
    vsd_taus = tuple(np.round(np.arange(0.05, 0.51, 0.05), 2)) if "vsd" in args.errors else ()
    err_cols = [e for e in args.errors if e != "vsd"] + [f"vsd:{t}" for t in vsd_taus]

    syms_cache: dict = {}
    if args.models_info:
        from freepose_tpu_torch.evaluation.symmetry import get_symmetry_transformations, load_models_info

        models_info = load_models_info(args.models_info)

        def _syms(obj_id):
            if obj_id not in syms_cache:
                info = models_info.get(obj_id, {})
                syms_cache[obj_id] = [
                    {"R": s["R"], "t": s["t"].reshape(3) / 1000.0}  # mm -> m
                    for s in get_symmetry_transformations(info)
                ]
            return syms_cache[obj_id]
    else:
        models_info = None

        def _syms(obj_id):
            return None

    gt_meshes: dict = {}
    inf_meshes: dict = {}
    diameters: dict = {}  # GT class -> diameter in metres
    renderer = None
    class_errors = {err: [] for err in err_cols}
    need_renderer = bool({"cus", "vsd"} & set(args.errors))

    points_cache: dict = {}  # id(mesh) -> one fixed-seed sample set

    def _points(mesh):
        if args.points == "vertices":
            return np.asarray(mesh.vertices)
        # One sample set per mesh (fixed seed): repeated runs and every
        # (estimate, GT) pair over the same mesh reuse identical points.
        key = id(mesh)
        if key not in points_cache:
            points_cache[key] = mesh.sample_surface(args.n_points, seed=0)
        return points_cache[key]

    shard = get_shard(args)
    for idx in shard.slice(len(dataset)):
        entry = dataset[idx]
        key = (entry["scene_id"], entry["frame_id"])
        ests = by_frame.get(key, [])
        gts = entry["gt"]
        if not gts:
            continue
        if targets_by_frame is not None:
            im_targets = targets_by_frame.get(key, {})
        else:  # every class present, all instances targeted
            im_targets = {}
            for g in gts:
                im_targets[g["obj_id"]] = im_targets.get(g["obj_id"], 0) + 1
        if not im_targets:
            continue
        k = entry["intrinsic"]
        if renderer is None and need_renderer:
            h, w = entry["image"].shape[:2]
            renderer = pe.MaskRenderer(w, h, device=dev)
        im_w = entry["image"].shape[1]
        visib = [i.get("visib_fract") for i in entry.get("gt_info", [])]
        visib = visib if len(visib) == len(gts) and all(v is not None for v in visib) else None
        gt_valid = gt_valid_mask(gts, im_targets, visib)

        # Raw errors of every estimate against every GT instance, one pass.
        frame_ests: list[EstimateErrors] = []
        for est in ests:
            if est.obj_id not in inf_meshes:
                # Loaded RAW, like the reference (eval_calc_errors.py:376-378,
                # inout.load_mesh scale=1.0): retrieval meshes on disk are
                # already unit-normalized by resize_meshes, so no re-centering
                # here; the estimate's scale is the only scaling applied.
                mesh = _load_mesh_any(
                    Path(args.inference_mesh_dir) / str(est.obj_id) / f"{est.obj_id}.obj",
                    Path(args.inference_mesh_dir) / f"{est.obj_id}.ply",
                )
                inf_meshes[est.obj_id] = mesh
                if renderer is not None:
                    renderer.add_object(est.obj_id, mesh)
            # Reference scales inference meshes by the estimate's scale
            # (eval_calc_errors.py:379-385).
            pts_est = _points(inf_meshes[est.obj_id]) * est.scale
            errs = {err: {} for err in err_cols}
            for gi, gt in enumerate(gts):
                obj_id = gt["obj_id"]
                if obj_id not in gt_meshes:
                    mesh = _load_mesh_any(
                        Path(args.models_dir) / f"obj_{obj_id:06d}.obj",
                        Path(args.models_dir) / f"obj_{obj_id:06d}.ply",
                    )
                    gt_meshes[obj_id] = mesh.scaled(0.001)  # BOP models in mm
                    if models_info and obj_id in models_info:
                        diameters[obj_id] = float(models_info[obj_id]["diameter"]) / 1000.0
                    else:
                        diameters[obj_id] = _true_diameter(gt_meshes[obj_id].vertices)
                    if renderer is not None:
                        renderer.add_object(f"gt{obj_id}", gt_meshes[obj_id])
                pts_gt = _points(gt_meshes[obj_id])
                r_gt = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
                t_gt = np.asarray(gt["cam_t_m2c"], np.float64).reshape(3) / 1000.0
                for err in args.errors:
                    if err == "chamfer":
                        e = pe.chamfer(est.R, est.t, r_gt, t_gt, pts_est, pts_gt, device=dev)
                    elif err == "chamfer_proj":
                        e = pe.chamfer_proj(est.R, est.t, r_gt, t_gt, k, pts_est, pts_gt, device=dev)
                    elif err == "cus":
                        e = pe.cus(est.R, est.t, r_gt, t_gt, k, renderer, est.obj_id, f"gt{obj_id}",
                                   est_scale=est.scale)
                    elif err == "mssd":
                        e = pe.mssd(est.R, est.t, r_gt, t_gt, pts_est, pts_gt, syms=_syms(obj_id), device=dev)
                    elif err == "mspd":
                        e = pe.mspd(est.R, est.t, r_gt, t_gt, k, pts_est, pts_gt, syms=_syms(obj_id), device=dev)
                    elif err == "vsd":
                        depth_test = entry.get("depth")
                        if depth_test is None:
                            raise SystemExit("vsd requires the dataset's test depth images")
                        diameter = diameters[obj_id]
                        vs = pe.vsd(est.R, est.t, r_gt, t_gt, depth_test, k,
                                    delta=args.vsd_delta, taus=vsd_taus,
                                    normalized_by_diameter=True, diameter=diameter,
                                    renderer=renderer, inf_id=est.obj_id, gt_id=f"gt{obj_id}",
                                    est_scale=est.scale)
                        for tau, v in zip(vsd_taus, vs):
                            errs[f"vsd:{tau}"][gi] = float(v)
                        continue
                    else:
                        raise ValueError(err)
                    errs[err][gi] = float(e)
            frame_ests.append(
                EstimateErrors(entry["scene_id"], entry["frame_id"], est.obj_id, est.score, errs)
            )

        # Per-class competition: each target class sees EVERY estimate of
        # the image, with errors restricted to its own GTs and normalized
        # at scoring time (reference eval_calc_scores.py:261-273).
        for obj_id in im_targets:
            cls_gis = [gi for gi, g in enumerate(gts) if g["obj_id"] == obj_id]
            if not cls_gis:
                continue
            for err in err_cols:
                base = err.split(":")[0]
                if base in ("chamfer", "mssd"):
                    norm = 1.0 / max(diameters.get(obj_id, 1.0), 1e-9)
                elif base in ("chamfer_proj", "mspd"):
                    norm = 640.0 / im_w
                else:
                    norm = 1.0
                cls_ests = [
                    EstimateErrors(
                        e.scene_id, e.im_id, e.obj_id, e.score,
                        {gi: e.errors[err][gi] * norm for gi in cls_gis if gi in e.errors[err]},
                    )
                    for e in frame_ests
                ]
                class_errors[err].append(
                    ClassErrors(entry["scene_id"], entry["frame_id"], obj_id,
                                cls_ests, gt_valid, gt_ids=cls_gis)
                )

    thresholds = dict(DEFAULT_ERROR_THRESHOLDS)
    for tau in vsd_taus:
        thresholds[f"vsd:{tau}"] = np.arange(0.05, 0.51, 0.05)  # BOP19 vsd sweep
    scores = bop19_average_recalls_classed(class_errors, thresholds)
    if vsd_taus:
        # AR_vsd = mean over the tau sweep (reference eval_bop19_pose.py:19-40);
        # fold the per-tau columns into one headline number.
        per_tau = [scores.pop(f"AR_vsd:{tau}") for tau in vsd_taus]
        scores["AR_vsd"] = float(np.mean(per_tau))
        ar_keys = [v for k2, v in scores.items() if k2.startswith("AR_")]
        scores["AR"] = float(np.mean(ar_keys))
    mean_time = float(np.mean([r.time for r in results if r.time >= 0])) if results else -1.0
    scores["mean_time_s"] = mean_time
    print(json.dumps(scores, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(scores))
    return scores


if __name__ == "__main__":
    main()
