"""The smooth cell (`video_smooth`) and the staged cell (`video_staged`) driven
through whole tiny runs on the CPU: set-up, window and check of a sound run
pass; each fault of faults_smooth.py (and the coupled faults the staged
cell's check reads) makes `correct` false; the smooth control reads worse
than the program; a program whose smooth_track keeps no interval record is
refused at once; and the layout holds with every cell."""
from __future__ import annotations

import copy
import importlib
import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark import faults, faults_smooth, run
from benchmark.tests.conftest import tiny_config

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def tiny_smooth_config() -> dict:
    """video-cotracker2-dinov2B at COTRACKER2_TEST's widths on 16-frame
    72x128 videos; the flow head scaled by 0.005, so that a track moves a
    pixel or so over an interval as the full one's moves ~10, and the
    visibility probe's bias set so that the tiny tracker's visibilities
    straddle 0.9 as the full one's do."""
    cfg = json.loads((BENCH / "configs" / "video-cotracker2-dinov2B.json").read_text())
    cfg["name"] = "tinysmooth"
    cfg["cotracker2"].update(latent_dim=16, corr_radius=1, flow_emb_dim=16, hidden_size=64, num_heads=4, depth=2,
                             num_virtual_tracks=4, model_resolution=[64, 96], iters=2, support_grid=3)
    cfg["random_weights"].update(flow_head_scale=0.005, visibility_bias=-1.0)
    cfg["dinov2_b"] = {"hidden_size": 64, "num_layers": 3, "num_heads": 4, "patch_size": 14, "num_registers": 4,
                       "mlp_ratio": 4.0, "image_size": 56}
    cfg["mesh"] = {"n_u": 16, "n_v": 8}
    cfg["video"].update(frames=16, height=72, width=128, object_res=32)
    cfg["smooth"].update(cap=64, cap_buckets=[32, 64])
    return cfg


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads a process: with one per core in each of several
    workers the tiny runs slow down several-fold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_cells(tmp_path_factory) -> Path:
    """A copy of benchmark/ holding the tiny smooth and staged cells."""
    dst = tmp_path_factory.mktemp("bench") / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "configs" / "tinysmooth.json").write_text(json.dumps(tiny_smooth_config()))
    staged = tiny_config()
    staged["video"]["frames"] = 6
    (dst / "configs" / "tiny.json").write_text(json.dumps(staged))
    for name, src, config in (("tinysmooth", "video.smooth.cotracker2", "tinysmooth"),
                              ("tinystaged", "video.staged.1obj", "tiny")):
        cell = json.loads((BENCH / "workloads" / f"{src}.json").read_text())
        cell.update(name=name, config=config)
        cell["params"]["videos"] = 2
        (dst / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return dst


def tiny_run(bench: Path, cell: str, seed: int = 5):
    """A smooth run's window ends with its first video; a staged window
    stops inside a video, so it runs long enough to finish one on a busy
    CPU."""
    return run.run_cell(cell, seed, 1.0 if cell == "tinysmooth" else 20.0, False, device="cpu", bench_dir=bench)


def test_a_sound_smooth_run_is_correct(tiny_cells):
    res = tiny_run(tiny_cells, "tinysmooth")
    assert res["correct"], res
    assert res["info"]["frames_posed"] % 16 == 0 and list(res)[-1] == "checks"
    assert set(res["checks"]) == {"track_err", "vis_gap", "pnp_rot_err", "pnp_trans_err", "smooth_err",
                                  "inliers_rank", "inliers_gap"}


def test_a_sound_staged_run_is_correct(tiny_cells):
    res = tiny_run(tiny_cells, "tinystaged")
    assert res["correct"], res
    assert set(res["checks"]) == {"crop_err", "pose_off_grid", "pose_gap", "score_err", "lift_err", "inliers_rank",
                                  "inliers_gap", "query_feat_err"}


def test_the_smooth_control_reads_worse_than_the_program(tiny_cells):
    workload = json.loads((tiny_cells / "workloads" / "tinysmooth.json").read_text())
    cfg = json.loads((tiny_cells / "configs" / "tinysmooth.json").read_text())
    traffic = importlib.import_module("benchmark.traffic.video_smooth")
    cell = traffic.setup(cfg, workload, 5, "cpu", False)
    cell.window(1.0)
    out = cell.check(control=True)
    prog, ctl = out["program"], out["control"]
    assert set(prog) == set(ctl)
    assert ctl["track_err"] > 10 * prog["track_err"], out


# The number each fault's reading on the card set a limit's upper end from
# (PERF.md): it has to read above its limit here too.
MEANT = {"cotracker2_iteration_dropped": "track_err", "cotracker2_overlap_dropped": "track_err",
         "cotracker2_corr_radius_2": "track_err", "cotracker2_support_dropped": "track_err",
         "cotracker2_visibility_half": "vis_gap", "surface_shuffled": "pnp_rot_err", "smoothing_skipped": "smooth_err",
         "staged_crops_shifted": "crop_err",
         "coarse_turned": "pose_off_grid", "refine_stale": "pose_off_grid", "refine_wrong_view": "pose_gap",
         "refine_lift_off": "lift_err", "inliers_unmasked": "inliers_gap"}
STAGED = ("staged_crops_shifted", "coarse_turned", "refine_stale", "refine_wrong_view", "refine_lift_off",
          "inliers_unmasked")


@pytest.mark.parametrize("fault", sorted(set(faults_smooth.FAULTS) | set(STAGED)))
def test_a_fault_planted_where_an_answer_or_a_state_is_produced_fails(tiny_cells, fault):
    module = faults_smooth if fault in faults_smooth.FAULTS else faults
    with module.plant(fault):
        res = tiny_run(tiny_cells, "tinystaged" if fault in STAGED else "tinysmooth")
    assert not res["correct"] and "error" not in res["info"], res
    check = res["checks"][MEANT[fault]]
    assert check["value"] > check["limit"], res["checks"]


def test_the_inliers_fault_fails_the_smooth_cell_too(tiny_cells):
    """The smooth cell judges the inliers at the coarse poses, through
    TrackingRefiner's confidence path: the coupled cell's inliers fault
    fails it there as well."""
    with faults.plant("inliers_unmasked"):
        res = tiny_run(tiny_cells, "tinysmooth")
    assert not res["correct"] and "error" not in res["info"], res
    check = res["checks"]["inliers_gap"]
    assert check["value"] > check["limit"], res["checks"]


def test_the_staged_control_reads_worse_than_the_program(tiny_cells):
    """The control (float8 products) in the program's place reads the query
    crops' features farther from the reference than the program (fp32 on
    the CPU) does."""
    workload = json.loads((tiny_cells / "workloads" / "tinystaged.json").read_text())
    cfg = json.loads((tiny_cells / "configs" / "tiny.json").read_text())
    traffic = importlib.import_module("benchmark.traffic.video_staged")
    cell = traffic.setup(cfg, workload, 5, "cpu", False)
    cell.window(20.0)
    out = cell.check(control=True)
    prog, ctl = out["program"], out["control"]
    assert set(prog) == set(ctl)
    assert ctl["query_feat_err"] > 10 * prog["query_feat_err"], out
    assert ctl["query_feat_err"] > workload["limits"]["query_feat_err"], out


def test_a_program_without_the_interval_record_is_refused_at_once(tiny_cells, monkeypatch):
    from freepose_tpu_torch.scripts import smooth_poses_video

    monkeypatch.delattr(smooth_poses_video, "INTERVAL_RECORD")
    workload = json.loads((tiny_cells / "workloads" / "tinysmooth.json").read_text())
    cfg = json.loads((tiny_cells / "configs" / "tinysmooth.json").read_text())
    traffic = importlib.import_module("benchmark.traffic.video_smooth")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="INTERVAL_RECORD"):
        traffic.setup(cfg, workload, 5, "cpu", False)
    assert time.perf_counter() - t0 < 5.0


def test_every_cell_is_found_by_name_with_three_cells(tmp_path):
    """The layout test's copy-and-drop check, for the benchmark as it now
    stands: a cell and a metric dropped into a copy are found beside every
    cell that is there."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in bench["workloads"]]
    assert {"video.coupled.1obj", "video.smooth.cotracker2", "video.staged.1obj"} <= set(names)
    copy_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy_dir, ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((copy_dir / "workloads" / "video.smooth.cotracker2.json").read_text())
    cell["name"] = "video.smooth.new"
    (copy_dir / "workloads" / "video.smooth.new.json").write_text(json.dumps(cell))
    (copy_dir / "metrics" / "frames_seen.smooth.py").write_text("def read(data):\n    return 7\n")
    bench = copy.deepcopy(bench)
    bench["workloads"].append({"name": "video.smooth.new", "config": cell["config"], "traffic": cell["traffic"],
                               "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "frames_seen.smooth", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "video_frames_per_s",
                               "workloads": ["video.smooth.new"]})
    assert [m["name"] for m in run.cell_metrics(bench, cell)] == ["frames_seen.smooth"]
    assert run.metric_reader("frames_seen.smooth", copy_dir)({}) == 7
    found = {p.stem for p in (copy_dir / "workloads").glob("*.json")}
    assert found == set(names) | {"video.smooth.new"}
    for name in names:
        metrics = run.cell_metrics(json.loads((ROOT / "BENCHMARK.json").read_text()),
                                   json.loads((BENCH / "workloads" / f"{name}.json").read_text()))
        assert metrics and all(callable(run.metric_reader(m["name"])) for m in metrics)
