"""SAM2's memory, host milliseconds per frame in the profiled video: the
program's `sam2.memory_gather`, `sam2.memory_attention` and
`sam2.memory_encoder` spans less the `wait.*` spans nested in them, over
`sam2.frames` (benchmark/program_spans.py)."""
from benchmark import program_spans

MEMORY = ("sam2.memory_gather", "sam2.memory_attention", "sam2.memory_encoder")


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name in MEMORY, "sam2.frames")
