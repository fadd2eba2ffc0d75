#!/usr/bin/env python3
"""readings.py for every cell and every fault: the comparison's readings on
the card at a cell's own size, of the program, of the control (`--control`)
or of the program with faults planted, from benchmark/faults.py or
benchmark/faults_smooth.py, which readings.py does not see. Per seed, the
cell's set-up and a short window at its own load, then the comparison. With
several faults, each is read on its own, in turn, one set-up per seed and
fault:

    python3 benchmark/readings_more.py --workload <name> --seconds <s> --seeds <n> [<n> ...]
        [--control] [--faults <fault> [<fault> ...]]

One JSON line per seed and fault (readings.py's fields), each side held to
the cell's limits as a run holds the program."""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import faults, faults_smooth, run  # noqa: E402  (run sets the cache directories first)

ALL = {**faults.FAULTS, **faults_smooth.FAULTS}


@contextlib.contextmanager
def planted(name: str | None):
    with contextlib.ExitStack() as stack:
        if name is not None:
            stack.enter_context(ALL[name]())
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(ALL))
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("readings_more: needs a CUDA card", file=sys.stderr)
        return 3
    workload = run.load_json(run.BENCH / "workloads" / f"{args.workload}.json")
    cfg = run.load_json(run.BENCH / "configs" / f"{workload['config']}.json")
    limits = workload.get("limits", {})
    traffic = importlib.import_module(f"benchmark.traffic.{workload['traffic']}")
    for fault in args.faults or [None]:
        for seed in args.seeds:
            with planted(fault):
                cell = traffic.setup(cfg, workload, seed, "cuda", False)
                win = cell.window(args.seconds)
                out = cell.check(control=args.control)
            line = {"seed": seed, "faults": [fault] if fault else [], "metrics": win["metrics"],
                    "memory_peak_bytes": torch.cuda.max_memory_allocated()}
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
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
