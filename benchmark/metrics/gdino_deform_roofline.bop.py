"""GroundingDINO's deformable attention's share of its roofline in a BOP
cell's profiled image: the least time of the work inside the program's
`gdino.deform` spans (the value, offset, weight and output projections, and
the samples the `gdino.deform_samples.*` counters count, each reading its
four taps' head channels; benchmark/flops_gdino.py) over the device time of
the kernels launched inside those spans. The yardstick of a fused sampling
kernel. Nothing where the program has no such span or counter."""
from benchmark import roofline


def read(data: dict):
    gd = data.get("gdino_deform")
    if gd is None:
        return None
    ops, nbytes = gd["work"]
    return roofline.share(roofline.bound_s(ops, nbytes), gd["device_s"])
