#!/usr/bin/env python3
"""The BOP cells' readings of the comparison that decides `correct`, on the
card at a cell's own size, to set each limit from. Per seed, one set-up;
then a short window and the comparison of the program (with the control
where `--control`), and again with each fault of benchmark/faults_bop.py
planted in the set-up program, in turn:

    python3 benchmark/readings_bop.py --workload <name> --seconds <s> --seeds <n> [<n> ...]
        [--control] [--faults <fault> [<fault> ...]]

One JSON line per seed and pass ({"seed", "faults", "metrics", "program",
"program_correct", with --control "control", "control_correct"}), each side
held to the cell's limits as a run holds the program."""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import faults_bop, run  # noqa: E402  (run sets the cache directories first)


def passes(cell, seconds: float, control: bool, fault_names: list[str]):
    """(fault or None, window result, comparison) of the program, then of
    each fault; each pass starts from an empty record and pack cache."""
    for name in [None, *fault_names]:
        cell.done = []
        if hasattr(cell, "tbank"):
            cell.tbank.cache.clear()
        cell.reset_graphs()
        with (faults_bop.FAULTS[name](cell) if name else contextlib.nullcontext()):
            win = cell.window(seconds)
        cell.reset_graphs()
        yield name, win, cell.check(control=control and name is None)


def main(argv=None, device: str = "cuda", bench_dir: Path = run.BENCH) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(faults_bop.FAULTS))
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if device == "cuda" and not torch.cuda.is_available():
        print("readings_bop: needs a CUDA card", file=sys.stderr)
        return 3
    workload = run.load_json(bench_dir / "workloads" / f"{args.workload}.json")
    cfg = run.load_json(bench_dir / "configs" / f"{workload['config']}.json")
    limits = workload.get("limits", {})
    traffic = importlib.import_module(f"benchmark.traffic.{workload['traffic']}")
    for seed in args.seeds:
        cell = traffic.setup(cfg, workload, seed, device, False)
        for fault, win, out in passes(cell, args.seconds, args.control, args.faults):
            line = {"seed": seed, "faults": [fault] if fault else [], "metrics": win["metrics"],
                    "images": win["images"], "proposals_per_image": win["proposals_per_image"]}
            if device == "cuda":
                line["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
            for side in ("program", "control"):
                if side in out:
                    line[side] = out[side]
                    line[f"{side}_correct"] = run.judged(out[side], limits)[0] and "error" not in out
            if "error" in out:
                line["error"] = out["error"]
            line["info"] = out.get("info", {})
            print(json.dumps(line), flush=True)
        del cell
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
