"""K2 d 64's share of its roofline in the profiled video: the least time
of the DINOv2-L and DINOv2-B attention on the images featurized (the
operations and bytes of benchmark/flops.py) over the device time of the
d 64 attention kernel."""
from benchmark import roofline


def read(data: dict):
    prof = data.get("profile")
    if prof is None:
        return None
    ops, nbytes = data["work"]["k2_d64"]
    return roofline.share(roofline.bound_s(ops, nbytes), roofline.group_device_s(prof["kernels"], "k2_d64"))
