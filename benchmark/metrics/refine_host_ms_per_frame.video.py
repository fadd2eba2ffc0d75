"""The fine refine's host milliseconds per refined frame in the profiled
video: the program's outermost `refine.*` spans (each AutoRefineChain
`refine.step`, and finalize_all's `refine.drain`) less the `wait.*` spans
nested in them, over the program's `refine.frames`
(benchmark/program_spans.py)."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name.startswith("refine."), "refine.frames")
