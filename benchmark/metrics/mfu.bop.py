"""A BOP cell's share of the card's bf16 peak, in %, over the part of a
traced window after its profiled image, which runs with no profiler as an
untraced window does: the operations of the images done there (GroundingDINO
from benchmark/flops_gdino.py; SAM2's trunk, neck and one mask decode per
box and DINOv2-L on the padded retrieval crops from benchmark/flops.py; with the
`bop_new_meshes` traffic also DINOv2-L on each pack's 600 views and each query crop)
over that wall time at 989 TFLOP/s."""
from benchmark import roofline


def read(data: dict):
    after = data["untraced"]
    if after["seconds"] <= 0 or after["flops"] <= 0:
        return None
    return 100.0 * after["flops"] / (after["seconds"] * roofline.PEAK_BF16_FLOPS)
