"""The comparison that decides `correct`, driven through a whole tiny run on
the CPU: a sound run passes, the control (the reference with float8
products in the program's place) reads worse than the program, and a run
whose outputs are altered where they are produced comes out not correct."""
from __future__ import annotations

import pytest

from benchmark import faults, run


def tiny_run(tiny_bench, seed=5, control=False, seconds=8.0):
    if not control:
        return run.run_cell("tiny", seed, seconds, False, device="cpu", bench_dir=tiny_bench)
    import importlib
    import json

    workload = json.loads((tiny_bench / "workloads" / "tiny.json").read_text())
    cfg = json.loads((tiny_bench / "configs" / "tiny.json").read_text())
    traffic = importlib.import_module(f"benchmark.traffic.{workload['traffic']}")
    cell = traffic.setup(cfg, workload, seed, "cpu", False)
    cell.window(seconds)
    return cell.check(control=True)


def test_a_sound_run_is_correct(tiny_bench):
    res = tiny_run(tiny_bench)
    assert res["correct"], res
    assert set(res["checks"]) and list(res)[-1] == "checks"


def test_the_control_reads_worse_than_the_program(tiny_bench):
    out = tiny_run(tiny_bench, control=True)
    prog, ctl = out["program"], out["control"]
    assert set(prog) == set(ctl)
    assert any(ctl[k] > prog[k] for k in prog), out


# The number each fault's reading on the card set a limit's upper end from
# (PERF.md): it has to read above its limit here too.
MEANT = {"sam2_masks_flipped": "sam2_logit_gap", "sam2_wrong_candidate": "sam2_choice_gap",
         "crops_shifted": "crop_err", "refine_turned": "pose_off_grid", "refine_stale": "pose_off_grid",
         "refine_wrong_view": "pose_gap", "refine_lift_off": "lift_err", "inliers_unmasked": "inliers_gap"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_planted_where_an_answer_or_a_state_is_produced_fails(tiny_bench, fault):
    with faults.plant(fault):
        res = tiny_run(tiny_bench)
    assert not res["correct"], res
    if fault in MEANT:
        check = res["checks"][MEANT[fault]]
        assert check["value"] > check["limit"], res["checks"]
