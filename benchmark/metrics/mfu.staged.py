"""The staged step's share of the card's bf16 peak, in %, over the part of a
traced window after its profiled video, which runs with no span and no
profiler as an untraced window does: the operations of the frames posed
there (benchmark/flops.py's DINOv2 work of a video frame: the query crop,
the fine views each chain's own miss counts say it featurized, the inliers'
two DINOv2-B images; no SAM2) over that wall time at 989 TFLOP/s."""
from benchmark import roofline


def read(data: dict):
    after = data["untraced"]
    if after["seconds"] <= 0 or after["flops"] <= 0:
        return None
    return 100.0 * after["flops"] / (after["seconds"] * roofline.PEAK_BF16_FLOPS)
