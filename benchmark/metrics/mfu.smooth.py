"""The smooth stage's share of the card's bf16 peak, in %, over the part of
a traced window after its profiled video, which runs with no profiler as an
untraced window does: the operations of the videos smoothed there
(CoTracker2 on each interval tracked, benchmark/flops_cotracker2.py;
DINOv2-B on the inliers' photo crops and renders, benchmark/flops.py; the
renders take no product) over that wall time at 989 TFLOP/s, as mfu.video
reads the coupled step."""
from benchmark import roofline


def read(data: dict):
    after = data["untraced"]
    if after["seconds"] <= 0 or after["flops"] <= 0:
        return None
    return 100.0 * after["flops"] / (after["seconds"] * roofline.PEAK_BF16_FLOPS)
