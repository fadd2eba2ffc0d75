"""StreamingInliers' host milliseconds per frame in the profiled video: the
program's outermost `inliers.*` spans (each chunk's `inliers.dispatch`, the
`inliers.finalize`) less the `wait.*` spans nested in them, over the
program's `inliers.frames` (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(data: dict):
    return program_spans.host_ms_per_frame(lambda name: name.startswith("inliers."), "inliers.frames")
