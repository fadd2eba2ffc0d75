"""GroundingDINO's host milliseconds per image in a BOP cell's profiled
image: the program's outermost `gdino.*` spans (text, backbone, encoder,
select, decoder) less the `wait.*` spans nested in them, over the program's
`gdino.images` (benchmark/program_spans.py). A program without these spans
gives nothing, and the metric is left out."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name.startswith("gdino."), "gdino.images")
