"""SAM2's image trunk, host milliseconds per frame in the profiled video:
the program's `sam2.trunk` spans (the frame's resize and Hiera trunk with its
neck) less the `wait.*` spans nested in them, over `sam2.frames`
(benchmark/program_spans.py)."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name == "sam2.trunk", "sam2.frames")
