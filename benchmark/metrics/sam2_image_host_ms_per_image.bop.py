"""SAM2's image path's host milliseconds per image in a BOP cell's profiled
image: the program's outermost `sam2.image.*` spans (the embedding, the
decode with its resize and fetch) less the `wait.*` spans nested in them,
over the program's `sam2.images` (benchmark/program_spans.py). A program
without these spans gives nothing, and the metric is left out."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name.startswith("sam2.image."), "sam2.images")
