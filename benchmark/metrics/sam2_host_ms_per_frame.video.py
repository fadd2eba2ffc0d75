"""SAM2's host milliseconds per frame in the profiled video: the program's
`sam2.batch` spans (each propagate_batched batch, closed before its yield)
less the `wait.*` spans nested in them, over the program's `sam2.frames`
(benchmark/program_spans.py)."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name == "sam2.batch", "sam2.frames")
