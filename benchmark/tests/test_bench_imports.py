"""Nothing the benchmark runs imports jax or the JAX package, and the
reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "freepose_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "freepose_tpu_torch" not in top_level_imports(path), path


def test_a_cpu_run_leaves_no_jax_module_loaded(tiny_bench):
    code = (
        "import sys, json; from pathlib import Path; from benchmark import run\n"
        f"res = run.run_cell('tiny', 11, 1.0, False, device='cpu', bench_dir=Path({str(tiny_bench)!r}))\n"
        "print(json.dumps({'bad': run.forbidden_modules(), 'correct': res['correct']}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"bad": []' in out.stdout.splitlines()[-1]
