"""SAM2's attention kernels' share of their roofline in the profiled video:
the least time of the Hiera global blocks (K2 d 72), memory self-attention
(K2 d 256) and memory cross-attention over the valid memory keys (K4) of
every frame (benchmark/flops.py) over the device time of the d 72 / d 256
builds, their split combine and K4's key-tile list kernel."""
from benchmark import roofline


def read(data: dict):
    prof = data.get("profile")
    if prof is None:
        return None
    ops, nbytes = data["work"]["sam2_attention"]
    return roofline.share(roofline.bound_s(ops, nbytes),
                          roofline.group_device_s(prof["kernels"], "sam2_attention"))
