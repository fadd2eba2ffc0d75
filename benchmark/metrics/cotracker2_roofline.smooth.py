"""CoTracker2's share of its roofline in the smooth cell's profiled video:
its least time (the larger of its fp32 operations over 67 TFLOP/s and its
bytes over 3.35 TB/s, benchmark/flops_cotracker2.py from the configuration's
shapes and the program's `cotracker2.frames`, `.windows`, `.iters` and
`.points` counters) over the device time of the kernels launched inside the
program's `cotracker2.*` spans (cuBLAS, cuDNN and ATen: CoTracker2 has no
kernel of its own, so this is the layer's share)."""
from benchmark import roofline


def read(data: dict):
    ct = data.get("cotracker2")
    if ct is None:
        return None
    ops, nbytes = ct["work"]
    return roofline.share(roofline.bound_s(ops, nbytes, roofline.PEAK_FP32_FLOPS), ct["device_s"])
