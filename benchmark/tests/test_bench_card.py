"""On the card: one short run of each cell through the benchmark's command,
with its result line. Marked `cuda`; skips without a GPU."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_and_is_correct_on_the_card(card, trace):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell["name"], "--seed", "2147483659",
                              "--seconds", "10", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["device"]["platform"] == "gpu", res
        assert list(res)[-1] == "checks"
