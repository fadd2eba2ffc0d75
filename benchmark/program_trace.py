"""Videos of the `video_coupled` traffic through the program with its own
tracer (freepose_tpu_torch/utils/timing.py), for what a `--trace 1` run does
not print:

    python -m benchmark.program_trace --seed 12345 --out .bench_cache/trace.json

from the root of a checkout, on a CUDA card. After the set-up of the cell
`video.coupled.1obj`, in one process:

1. cost: untraced videos outside and inside `timing.tracing()` in turns
   (out, in, in, out, out, in): ms per frame each, synchronised at the ends;
2. profile: one video under torch.profiler with CPU and CUDA activity (no
   benchmark span, so nothing synchronises): host ms per frame by program
   span (less the wait spans nested in it), the waits, and the card's idle
   seconds by the innermost program span open when each gap began, with the
   offset between the trace's range starts and the records' perf_counter_ns;
3. sync: one video under `torch.cuda.set_sync_debug_mode("warn")` inside
   `timing.tracing()`: each call that synchronised, by its innermost frame
   in the program or the benchmark and the program spans open around it.

Writes one JSON object to --out and prints its summary."""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import statistics
import subprocess
import time
import traceback
import warnings
from pathlib import Path

from benchmark import run as bench_run  # noqa: F401  (the run's thread and cache settings)
from benchmark import program_spans

ROOT = Path(__file__).resolve().parent.parent


def _video(cell, i: int) -> tuple[dict, float]:
    """Video i of the cell's set, to its end -> (its record, wall s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = cell._run_video(cell.videos[i % len(cell.videos)], f"trace{i}", math.inf)
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t0


def innermost_at(records, times: list[int]) -> list[tuple[str, str]]:
    """(innermost, outermost) program span open at each of the ascending
    `times` ("host" where none is)."""
    spans = program_spans.nested(records)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append((stack[-1][0], stack[0][0]) if stack else ("host", "host"))
    return out


def phase_cost(cell, start: int) -> dict:
    from freepose_tpu_torch.utils import timing

    ms = {"outside": [], "inside": []}
    for j, where in enumerate(("outside", "inside", "inside", "outside", "outside", "inside")):
        with timing.tracing() if where == "inside" else contextlib.nullcontext():
            rec, secs = _video(cell, start + j)
        ms[where].append(1e3 * secs / rec["posed"])
    return {"ms_per_frame": ms, "median": {k: statistics.median(v) for k, v in ms.items()}}


def phase_profile(cell, index: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.spans import busy_intervals
    from freepose_tpu_torch.utils import timing

    timing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter_ns()
        rec, secs = _video(cell, index)
        w1 = time.perf_counter_ns()
    records, counts = list(timing.records), dict(timing.counts)
    names = {r[0] for r in records}
    ranges, device = collections.defaultdict(list), []
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:  # a program range; on the card's rows, its kernels' extent
            if e.device_type() != DeviceType.CUDA:
                ranges[e.name()].append(e.start_ns())
        elif e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    # Offset: records' perf_counter_ns less the trace's start of the same
    # range (the n-th range of a name is the n-th record of it).
    starts = collections.defaultdict(list)
    for name, _p, t0, _t1 in records:
        starts[name].append(t0)
    diffs = sorted(t - r for name in starts for t, r in zip(sorted(starts[name]), sorted(ranges.get(name, []))))
    offset = statistics.median(diffs) if diffs else 0
    events = [(n, s + offset, e + offset) for n, s, e in device if e + offset > w0 and s + offset < w1]
    busy = busy_intervals([(n, max(s, w0), min(e, w1)) for n, s, e in events])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    where = innermost_at(records, [s for s, _ in gaps])
    idle_inner, idle_outer = collections.defaultdict(float), collections.defaultdict(float)
    for (s, e), (inner, outer) in zip(gaps, where):
        idle_inner[inner] += (e - s) * 1e-9
        idle_outer[outer] += (e - s) * 1e-9
    frames = counts.get("sam2.frames", 0) or rec["sam2_frames"]
    host = {name: program_spans.host_ns(records, lambda n, _m=name: n == _m) / 1e6 / frames
            for name in sorted(names)}
    waits = [r for r in records if program_spans.is_wait(r[0])]
    return {"frames": frames, "posed": rec["posed"], "wall_s": secs, "window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9, "launches": sum(1 for n, _, _ in events
                                                                           if not n.startswith(("Memcpy", "Memset"))),
            "offset_ns": offset,
            "offset_p5_p95_ns": [diffs[len(diffs) // 20], diffs[-1 - len(diffs) // 20]] if diffs else None,
            "ranges_matched": len(diffs), "records": len(records), "counts": counts,
            "host_ms_per_frame_by_span": host,
            "waits_per_frame": collections.Counter(r[0] for r in waits),
            "wait_ms_by_name": {n: sum(r[3] - r[2] for r in waits if r[0] == n) / 1e6 for n in {r[0] for r in waits}},
            "idle_s_by_innermost_span": dict(sorted(idle_inner.items(), key=lambda kv: -kv[1])),
            "idle_s_by_outermost_span": dict(sorted(idle_outer.items(), key=lambda kv: -kv[1]))}


def phase_sync(cell, index: int) -> dict:
    import torch

    from freepose_tpu_torch.utils import timing

    caught = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(str(ROOT)) and "/benchmark/program_trace.py" not in f.filename]
        caught.append((time.perf_counter_ns(), str(message).splitlines()[0][:120],
                       [f"{Path(f.filename).relative_to(ROOT)}:{f.lineno} {f.name}" for f in frames[-3:]]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with timing.tracing():
                rec, _ = _video(cell, index)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        records = list(timing.records)
    open_at = []
    for t, _msg, _where in caught:
        open_at.append(" > ".join(r[0] for r in sorted((r for r in records if r[2] <= t <= r[3]),
                                                        key=lambda r: r[2])) or "-")
    sites = collections.Counter((where[-1] if where else "?", msg, spans)
                                for (_, msg, where), spans in zip(caught, open_at))
    return {"frames": rec["sam2_frames"], "syncs": len(caught),
            "sites": [{"site": s, "message": m, "spans": sp, "count": c, "in_wait": "wait." in sp}
                      for (s, m, sp), c in sites.most_common()],
            "callers": sorted({" <- ".join(reversed(w)) for _, _, w in caught})}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("program_trace: needs a CUDA card")
    torch.set_num_threads(1)
    bench = ROOT / "benchmark"
    workload = bench_run.load_json(bench / "workloads" / "video.coupled.1obj.json")
    cfg = bench_run.load_json(bench / "configs" / f"{workload['config']}.json")
    from benchmark.traffic import video_coupled

    t0 = time.perf_counter()
    cell = video_coupled.setup(cfg, workload, args.seed, "cuda", False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": smi, "torch": torch.__version__, "seed": args.seed, "setup_s": time.perf_counter() - t0}
    out["cost"] = phase_cost(cell, 0)
    out["profile"] = phase_profile(cell, 6)
    out["sync"] = phase_sync(cell, 7)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    p = out["profile"]
    summary = {k: v for k, v in out.items() if k not in ("profile", "sync")}
    summary["profile"] = {k: p[k] for k in ("frames", "wall_s", "busy_s", "window_s", "offset_ns", "offset_p5_p95_ns",
                                            "ranges_matched", "waits_per_frame", "idle_s_by_innermost_span")}
    summary["profile"]["host_ms_per_frame_by_span"] = {k: round(v, 3) for k, v in p["host_ms_per_frame_by_span"].items()}
    summary["sync"] = {k: out["sync"][k] for k in ("frames", "syncs", "sites")}
    print(json.dumps(summary, indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
