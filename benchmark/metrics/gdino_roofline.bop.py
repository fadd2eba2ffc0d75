"""GroundingDINO-B's share of its roofline in a BOP cell's profiled image:
its least time (the larger of its operations over 989 TFLOP/s and its bytes
over 3.35 TB/s; benchmark/flops_gdino.py on the configuration's shapes and
the program's `gdino.images`, `.tokens`, `.queries` and `.deform_samples.*`
counters: Swin, BERT, the encoder, the selection and the decoder) over the
device time of the kernels launched inside the program's `gdino.*` spans,
placed by their launch's correlation id. Nothing where the program has no
such span or counter."""
from benchmark import roofline


def read(data: dict):
    gd = data.get("gdino")
    if gd is None:
        return None
    ops, nbytes = gd["work"]
    return roofline.share(roofline.bound_s(ops, nbytes), gd["device_s"])
