"""The port's copies of the JAX-free evaluation modules against the JAX
package's: score (BOP19 matching and recalls), symmetry, video_metrics
(drift over frame gaps), vos_metrics (J&F) and config.PipelineConfig, on
seeded numpy inputs. The code is copied, so every result is exactly equal.
"""
import dataclasses

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import freepose_tpu.config as jcfg
import freepose_tpu.evaluation.score as jscore
import freepose_tpu.evaluation.symmetry as jsym
import freepose_tpu.evaluation.video_metrics as jvm
import freepose_tpu.evaluation.vos_metrics as jvos
import freepose_tpu_torch.config as tcfg
import freepose_tpu_torch.evaluation.score as tscore
import freepose_tpu_torch.evaluation.symmetry as tsym
import freepose_tpu_torch.evaluation.video_metrics as tvm
import freepose_tpu_torch.evaluation.vos_metrics as tvos


def _class_errors(mod, seed):
    """Seeded per-(image, class) errors of 3-5 estimates against 1-3 GTs,
    with ties in score and error, in the module's own dataclasses."""
    rng = np.random.default_rng(seed)
    out = []
    for im in range(6):
        n_gt = int(rng.integers(1, 4))
        gts = [{"obj_id": int(rng.integers(1, 3))} for _ in range(n_gt)]
        visib = rng.random(n_gt).round(1).tolist()
        targets = {g["obj_id"]: int(rng.integers(1, 3)) for g in gts}
        valid = mod.gt_valid_mask(gts, targets, visib if im % 2 else None)
        for obj_id in sorted(targets):
            gis = [i for i, g in enumerate(gts) if g["obj_id"] == obj_id]
            ests = [mod.EstimateErrors(1, im, "m", float(rng.choice([0.3, 0.5, 0.9])),
                                       {gi: float(rng.choice([0.04, 0.1, 0.2, rng.random() * 0.6])) for gi in gis})
                    for _ in range(int(rng.integers(3, 6)))]
            out.append(mod.ClassErrors(1, im, obj_id, ests, valid, gt_ids=gis))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_matches_jax(seed):
    ref = {"cus": _class_errors(jscore, seed), "mssd": _class_errors(jscore, seed + 10)}
    ours = {"cus": _class_errors(tscore, seed), "mssd": _class_errors(tscore, seed + 10)}
    assert tscore.bop19_average_recalls_classed(ours) == jscore.bop19_average_recalls_classed(ref)
    for t in (0.05, 0.1, 0.3):
        assert tscore.localization_recall(ours["cus"], t) == jscore.localization_recall(ref["cus"], t)
        for o, r in zip(ours["cus"], ref["cus"]):
            assert tscore.greedy_match(o.ests, t, o.gt_valid) == jscore.greedy_match(r.ests, t, r.gt_valid)
    # The per-frame protocol (match_poses / bop19_average_recalls).
    frames_t = [([e for e in ce.ests], len(ce.gt_valid)) for ce in ours["cus"]]
    frames_j = [([e for e in ce.ests], len(ce.gt_valid)) for ce in ref["cus"]]
    assert tscore.bop19_average_recalls({"cus": frames_t}) == jscore.bop19_average_recalls({"cus": frames_j})
    assert all(np.array_equal(tscore.DEFAULT_ERROR_THRESHOLDS[k], v)
               for k, v in jscore.DEFAULT_ERROR_THRESHOLDS.items())


def test_symmetry_matches_jax(tmp_path):
    info = {"diameter": 120.0, "symmetries_discrete": [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 5.0, 0, 0, 0, 1]],
            "symmetries_continuous": [{"axis": [0, 0.3, 1], "offset": [1.0, 2.0, 0.0]}]}
    for model_info, step in ((info, 0.05), ({"diameter": 1.0}, 0.01), (info, 0.3)):
        ours = tsym.get_symmetry_transformations(model_info, step)
        ref = jsym.get_symmetry_transformations(model_info, step)
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            assert np.array_equal(a["R"], b["R"]) and np.array_equal(a["t"], b["t"])
    path = tmp_path / "models_info.json"
    path.write_text('{"1": {"diameter": 10.0}, "12": {"diameter": 3.5}}')
    assert tsym.load_models_info(path) == jsym.load_models_info(path) == {1: {"diameter": 10.0}, 12: {"diameter": 3.5}}


def _track(seed, n=24):
    rng = np.random.default_rng(seed)
    gt_r = Rotation.from_rotvec(np.cumsum(rng.normal(size=(n, 3)) * 0.05, axis=0)).as_matrix()
    gt_t = np.cumsum(rng.normal(size=(n, 3)) * 0.01, axis=0) + [0.0, 0.0, 1.0]
    est_r = Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.03).as_matrix() @ gt_r
    est_t = gt_t + rng.normal(size=(n, 3)) * 0.01
    return est_r, est_t, gt_r, gt_t


@pytest.mark.parametrize("sym_axis", [None, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)])
def test_video_metrics_match_jax(sym_axis):
    est_r, est_t, gt_r, gt_t = _track(3)
    sym_axis = None if sym_axis is None else np.asarray(sym_axis)
    dts = jvm.default_dts(len(est_r))
    assert np.array_equal(tvm.default_dts(len(est_r)), dts)
    assert tvm.average_rot_errors_dt(est_r, gt_r, dts, sym_axis=sym_axis, n_symmetries=31) == \
        jvm.average_rot_errors_dt(est_r, gt_r, dts, sym_axis=sym_axis, n_symmetries=31)
    k = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    for kk in (None, k):
        assert tvm.average_proj_errors_dt(est_r, est_t, gt_t, 0.14, dts, 640, 480, k=kk) == \
            jvm.average_proj_errors_dt(est_r, est_t, gt_t, 0.14, dts, 640, 480, k=kk)
    assert tvm.average_depth_errors_dt(est_r, est_t, gt_t, 0.14, 0.15, dts) == \
        jvm.average_depth_errors_dt(est_r, est_t, gt_t, 0.14, 0.15, dts)
    assert np.array_equal(tvm.rot_errors(est_r, gt_r, 3, sym_axis=sym_axis),
                          jvm.rot_errors(est_r, gt_r, 3, sym_axis=sym_axis))


@pytest.mark.parametrize("seed", [0, 1])
def test_vos_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    gt = np.zeros((7, 40, 48), bool)
    for t in range(7):
        gt[t, 5 + t:25 + t, 8:30] = True
    pred = np.roll(gt, int(rng.integers(1, 4)), axis=2) & (rng.random(gt.shape) > 0.05)
    pred[3] = False  # an empty prediction
    for skip in (True, False):
        assert tvos.track_j_and_f(pred, gt, skip) == jvos.track_j_and_f(pred, gt, skip)
    for i in range(7):
        assert tvos.jaccard(pred[i], gt[i]) == jvos.jaccard(pred[i], gt[i])
        assert tvos.boundary_f_measure(pred[i], gt[i]) == jvos.boundary_f_measure(pred[i], gt[i])


def test_pipeline_config_matches_jax(tmp_path):
    assert dataclasses.asdict(tcfg.PipelineConfig()) == dataclasses.asdict(jcfg.PipelineConfig())
    cfg = jcfg.PipelineConfig(template_views=64, fine_poses=2000, feature_type="cls")
    cfg.save(tmp_path / "cfg.json")
    (tmp_path / "extra.json").write_text((tmp_path / "cfg.json").read_text()[:-1] + ', "unknown_knob": 3}')
    for name in ("cfg.json", "extra.json"):
        assert dataclasses.asdict(tcfg.PipelineConfig.load(tmp_path / name)) == dataclasses.asdict(cfg)
    tcfg.PipelineConfig(dino_layer=12).save(tmp_path / "ours.json")
    jcfg.PipelineConfig(dino_layer=12).save(tmp_path / "ref.json")
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
