#!/usr/bin/env python3
"""Run one cell of the benchmark of freepose_tpu_torch on the card(s) of
this machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is benchmark/workloads/<name>.json; it names its configuration
(benchmark/configs/), its traffic mix (benchmark/traffic/<mix>.py) and its
end-to-end metrics; the per-layer metrics it reports are those of
BENCHMARK.json that list it (or, listing no cell, move one of its
end-to-end metrics), each read by benchmark/metrics/<metric>.py. With
--trace 0 the line holds the end-to-end metrics, with --trace 1 the
per-layer ones, read from the spans, counters and profiler trace of a
traced window. Every run judges the window's outputs against the
reference (benchmark/reference/) and prints each number compared beside
its limit, last on standard error and last in the line ("checks").

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), without the program beside the benchmark, or when jax,
jaxlib, flax or the JAX package were imported."""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# Build and kernel caches at fixed paths inside the checkout (.gitignore
# lists them): only a cell's first run in a checkout builds.
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
# One host thread for PyTorch's and numpy's CPU work: the path is bound by
# the host's kernel launches, which idle threads spinning on the same cores
# would slow by a varying amount.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
FORBIDDEN = ("jax", "jaxlib", "flax", "freepose_tpu")
NOT_A_READING = 1e30


class Refused(Exception):
    """No result can be printed (no card, no program, a forbidden import)."""


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_metrics(benchmark: dict, workload: dict) -> list[dict]:
    """The per-layer metrics of BENCHMARK.json that this cell reports."""
    name, e2e = workload["name"], set(workload["end_to_end"])
    return [m for m in benchmark.get("per_layer", [])
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def metric_reader(name: str, bench_dir: Path = BENCH):
    """<bench_dir>/metrics/<name>.py's `read`."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """The numbers a comparison read, held to a cell's limits -> (every
    number within its limit, {name: {"value", "limit"}}). A number the
    comparison could not read (no video finished) or that is not finite
    prints as NOT_A_READING, which fails every limit, so the line stays
    plain JSON."""
    values = {name: numbers.get(name, float("inf")) for name in limits}
    ok = bool(limits) and all(values[name] <= limit for name, limit in limits.items())
    return ok, {name: {"value": v if math.isfinite(v) else NOT_A_READING, "limit": limits[name]}
                for name, v in values.items()}


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool, device="cuda", bench_dir: Path = BENCH,
             benchmark_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """One run of a cell -> the result line's object (without printing).
    The cell, its configuration and its metric readers are read from
    `bench_dir`."""
    import torch

    if torch.device(device).type == "cuda":
        torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    if not (ROOT / "freepose_tpu_torch").is_dir():
        raise Refused(f"the program (freepose_tpu_torch/) is not beside the benchmark under {ROOT}")
    workload = load_json(bench_dir / "workloads" / f"{workload_name}.json")
    cfg = load_json(bench_dir / "configs" / f"{workload['config']}.json")
    benchmark = load_json(benchmark_file) if benchmark_file.exists() else {}
    units = {m["name"]: m["unit"] for m in benchmark.get("end_to_end", []) + benchmark.get("per_layer", [])}
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
            raise Refused(f"the cell needs {workload['chips']} CUDA card(s); "
                          f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    traffic = importlib.import_module(f"benchmark.traffic.{workload['traffic']}")

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cell = traffic.setup(cfg, workload, seed, device, trace)
    sync()
    setup_s = time.perf_counter() - t0
    win = cell.window(seconds)
    sync()
    on_card = torch.device(device).type == "cuda"
    result = {"correct": False, "attempted": win["attempted"], "failed": win["failed"], "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": workload["chips"],
                         "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}}
    idle_by_span = None
    if trace:
        data = cell.layer_data()
        for m in cell_metrics(benchmark, workload):
            value = metric_reader(m["name"], bench_dir)(data)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        prof = data.get("profile")
        if prof is not None:
            result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
            idle_by_span = prof["idle_by_span"]
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for name in workload["end_to_end"]:
            result["metrics"][name] = {"value": values[name], "unit": units.get(name, "")}
    verdict = cell.check()
    numbers = verdict.get("program", {})
    ok, checks = judged(numbers, workload.get("limits", {}))
    result["correct"] = ok and "error" not in verdict
    result["info"] = {**{k: v for k, v in win.items() if k not in ("metrics", "attempted", "failed")},
                      "setup_s": setup_s,
                      "numbers": {k: v if math.isfinite(v) else NOT_A_READING for k, v in numbers.items()},
                      **verdict.get("info", {}), **({"error": verdict["error"]} if "error" in verdict else {}),
                      **({"idle_s_by_span": idle_by_span} if idle_by_span else {})}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
        bad = forbidden_modules()
        if bad:
            raise Refused(f"modules of jax, jaxlib, flax or the JAX package were imported: {bad}")
    except Refused as e:
        print(f"benchmark refused: {e}", file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
