"""The benchmark is driven by its data: every cell names files that exist,
and a cell or metric added as a file is found without editing another."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def benchmark_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_names_a_config_a_traffic_mix_and_metric_readers():
    bench = benchmark_json()
    cells = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
    assert cells and sorted(w["name"] for w in bench["workloads"]) == cells
    for name in cells:
        cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
        assert cell["name"] == name
        assert (BENCH / "configs" / f"{cell['config']}.json").is_file()
        assert (BENCH / "traffic" / f"{cell['traffic']}.py").is_file()
        metrics = run.cell_metrics(bench, cell)
        assert metrics
        for m in metrics:
            assert callable(run.metric_reader(m["name"]))
            assert m["moves"] in cell["end_to_end"]
        assert "setup_s" in cell["end_to_end"] and cell["limits"]


def test_benchmark_json_keeps_to_the_contract_s_names_and_keys():
    bench = benchmark_json()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_a_cell_and_a_metric_dropped_into_a_copy_are_found(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((copy / "workloads" / "video.coupled.1obj.json").read_text())
    cell["name"] = "video.coupled.new"
    (copy / "workloads" / "video.coupled.new.json").write_text(json.dumps(cell))
    (copy / "metrics" / "frames_seen.video.py").write_text("def read(data):\n    return data['sam2_frames']\n")
    bench = benchmark_json()
    bench["workloads"].append({"name": "video.coupled.new", "config": cell["config"], "traffic": cell["traffic"],
                               "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "frames_seen.video", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "model: models/sam2",
                               "moves": "video_frames_per_s", "workloads": ["video.coupled.new"]})
    found = [m["name"] for m in run.cell_metrics(bench, cell)]
    assert found == ["frames_seen.video"]
    assert run.metric_reader("frames_seen.video", copy)({"sam2_frames": 7}) == 7
    assert sorted(p.stem for p in (copy / "workloads").glob("*.json"))[-1] == "video.coupled.new"
