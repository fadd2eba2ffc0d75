"""CoTracker2's host milliseconds per frame in the smooth cell's profiled
video: the program's outermost `cotracker2.*` spans (each interval's
`cotracker2.encoder` and its `cotracker2.window`s) less the `wait.*` spans
nested in them, over the program's `smooth.frames`
(benchmark/program_spans.py)."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name.startswith("cotracker2."), "smooth.frames")
