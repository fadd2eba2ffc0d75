"""The BOP cells (`bop_proposals`, `bop_new_meshes`) driven through whole
tiny runs on the CPU: both finish an image and judge it correct; each fault
of faults_bop.py makes `correct` false, held to limits a tiny fp32 program
meets with room (the program reads ~1e-6 here, the faults 5e-3 and more);
the control reads worse than the program; flops_gdino.py's counts match a
hand count."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest

from benchmark import faults_bop, flops_gdino, run
from benchmark.tests.bop_tiny import tiny_bop_bench

TINY_LIMIT = 1e-3


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_bop(tmp_path_factory):
    bench = tiny_bop_bench(tmp_path_factory.mktemp("bop"))
    for name in ("tinyprop", "tinynew"):
        path = bench / "workloads" / f"{name}.json"
        cell = json.loads(path.read_text())
        cell["limits"] = {k: (0 if k == "pose_off_grid" else TINY_LIMIT) for k in cell["limits"]}
        path.write_text(json.dumps(cell))
    return bench


@pytest.mark.parametrize("cell", ["tinyprop", "tinynew"])
def test_a_tiny_run_finishes_an_image_and_judges_it(tiny_bop, cell):
    res = run.run_cell(cell, 2**31 + 77, 1.0, False, device="cpu", bench_dir=tiny_bop)
    assert res["correct"], res["checks"]
    assert res["metrics"]["video_frames_per_s"]["value"] > 0 and res["metrics"]["setup_s"]["value"] > 0
    assert res["info"]["images"] >= 1 and "error" not in res["info"]
    numbers = set(res["checks"])
    assert {"gdino_memory_err", "gdino_select_gap", "sam2_logit_gap", "retrieval_gap"} <= numbers
    assert ("pack_feat_err" in numbers) == (cell == "tinynew")


def _readings(bench, cell, faults, control=False):
    import importlib

    from benchmark import readings_bop

    workload = run.load_json(bench / "workloads" / f"{cell}.json")
    cfg = run.load_json(bench / "configs" / f"{workload['config']}.json")
    traffic = importlib.import_module(f"benchmark.traffic.{workload['traffic']}")
    c = traffic.setup(cfg, workload, 91, "cpu", False)
    out = {}
    for fault, _win, verdict in readings_bop.passes(c, 0.5, control, faults):
        out[fault] = verdict
    return workload["limits"], out


def test_each_planted_fault_is_not_correct(tiny_bop):
    detector = [f for f in faults_bop.FAULTS if f not in faults_bop.POSE_FAULTS]
    for cell, faults in (("tinyprop", detector), ("tinynew", list(faults_bop.POSE_FAULTS))):
        limits, out = _readings(tiny_bop, cell, faults, control=True)
        assert run.judged(out[None]["program"], limits)[0], out[None]["program"]
        assert not run.judged(out[None]["control"], limits)[0]
        for fault in faults:
            assert "error" not in out[fault], (fault, out[fault])
            assert not run.judged(out[fault]["program"], limits)[0], (fault, out[fault]["program"])


def test_flops_gdino_matches_a_hand_count():
    g = {"image_size": 32, "swin": {"embed_dim": 8, "depths": [1], "num_heads": [1], "window_size": 4,
                                    "patch_size": 4, "mlp_ratio": 4.0, "out_stages": [0]}}
    # An 8x8 grid: the 4x4 patch embedding, then one block of 4 windows.
    patch = 2 * 8 * 8 * 3 * 16 * 8
    qkv, proj, mlp = 2 * 64 * 8 * 24, 2 * 64 * 8 * 8, 2 * (2 * 64 * 8 * 32)
    attn = 4 * (4 * 16 * 16 * 8)
    assert flops_gdino.swin(g)[0] == patch + qkv + proj + mlp + attn
    t = {"d_model": 32, "encoder_heads": 4, "num_feature_levels": 3}
    assert flops_gdino.samples(t, 10) == (2 * 5 * 8 * 10, 10 * (4 * 8 + 3) * 2)
    full = run.load_json(run.BENCH / "configs" / "bop-gdinoB-hieraL-dinov2L.json")
    g = full["grounding_dino"]
    assert flops_gdino.stage_sides(g) == [100, 50, 25, 13]
    tokens = sum(s * s for s in flops_gdino.stage_sides(g))
    assert tokens == 13294
    work = flops_gdino.work(full, 2, 2 * tokens, 1800, 2 * tokens * 128 * 6, 1800 * 128 * 6)
    one = flops_gdino.work(full, 1, tokens, 900, tokens * 128 * 6, 900 * 128 * 6)
    assert math.isclose(work["total"][0], 2 * one["total"][0]) and work["deform"][0] < work["total"][0]
    assert 0.7e12 < flops_gdino.image_ops(full) < 1.0e12  # Swin-B at 800²: ~0.47 T; the transformer ~0.35 T


def test_threshold_between_drops_or_keeps_the_ties_at_k():
    from benchmark.bop import threshold_between

    scores = [0.9, 0.8, 0.7, 0.7, 0.7, 0.5, 0.4]
    assert threshold_between(scores, 2) == pytest.approx(0.75)
    assert threshold_between(scores, 2, keep_ties=True) == pytest.approx(0.75)
    assert sum(s > threshold_between(scores, 3) for s in scores) == 2  # the tie at the 3rd falls under
    assert sum(s > threshold_between(scores, 3, keep_ties=True) for s in scores) == 5
    assert sum(s > threshold_between(scores, 6, keep_ties=True) for s in scores) == 6


def test_first_k_breaks_the_tie_at_k_by_position():
    from benchmark.bop import first_k, threshold_between

    scores = np.array([0.7, 0.9, 0.5, 0.7, 0.8, 0.7, 0.4])
    kept = scores[scores > threshold_between(scores, 3, keep_ties=True)]  # 0.7, 0.9, 0.7, 0.8, 0.7
    assert first_k(kept, 3).tolist() == [0, 1, 3]  # 0.9, 0.8 and the first of the three 0.7s
    assert first_k(kept, 5).tolist() == [0, 1, 2, 3, 4]
    assert first_k(kept, 9).tolist() == [0, 1, 2, 3, 4]
