"""Milliseconds per frame the host spent blocked on the card in the
profiled video: the program's outermost `wait.*` spans (a host copy's
event, a fetch), over `sam2.frames` (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(program_spans.is_wait, "sam2.frames")
