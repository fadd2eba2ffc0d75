#!/usr/bin/env python3
"""Readings of the comparison that decides `correct`, on the card at a
cell's own size, to set each limit from: for each seed, the cell's set-up
and a short window at its own load, then the comparison, with the control
(the reference with float8 products) in the program's place as well as the
program, or with faults planted in the program (benchmark/faults.py).

    python3 benchmark/readings.py --workload <name> --seconds <s> --seeds <n> [<n> ...]
        [--control] [--faults <fault> [<fault> ...]]

One JSON line per seed: {"seed", "faults", "program": {number: value},
"program_correct", and with --control "control", "control_correct"}, each
side held to the cell's limits as a run holds the program. The benchmark's
own runs read neither the control nor a fault."""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import faults, run  # noqa: E402  (run sets the cache directories first)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 3
    workload = run.load_json(run.BENCH / "workloads" / f"{args.workload}.json")
    cfg = run.load_json(run.BENCH / "configs" / f"{workload['config']}.json")
    limits = workload.get("limits", {})
    traffic = importlib.import_module(f"benchmark.traffic.{workload['traffic']}")
    for seed in args.seeds:
        with faults.plant(*args.faults):
            cell = traffic.setup(cfg, workload, seed, "cuda", False)
            win = cell.window(args.seconds)
            out = cell.check(control=args.control)
        line = {"seed": seed, "faults": args.faults, "metrics": win["metrics"]}
        for side in ("program", "control"):
            if side in out:
                line[side] = out[side]
                line[f"{side}_correct"] = run.judged(out[side], limits)[0] and "error" not in out
        if "error" in out:
            line["error"] = out["error"]
        line["info"] = out.get("info", {})
        print(json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
