"""Times per frame the host blocked on the card in the profiled video: the
program's `wait.*` spans, over `sam2.frames` (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(data: dict):
    s = program_spans.session()
    if s is None or not s[1].get("sam2.frames"):
        return None
    records, counts = s
    return sum(program_spans.is_wait(r[0]) for r in records) / counts["sam2.frames"]
