"""Frozen plain copies of the port's model and geometry modules, taken from
freepose_tpu_torch at the commit that added the benchmark and cut to their
plain paths: attention is `attention.py`'s softmax, the rasterizer is its
plain per-pose version, and no module here loads a kernel. The reference
builds its models from these at float32, so a later change to the port
changes nothing here."""
