"""freepose_tpu_torch — the PyTorch/CUDA port of freepose_tpu for NVIDIA Hopper.

The package mirrors freepose_tpu module by module (same names, same public
signatures, same array layouts) so each function has an obvious counterpart
in the JAX reference. Plain tensor code is PyTorch; the two TPU kernels on
the static coarse-pose path are hand-written CUDA C++ for sm_90a
(csrc/raster_tile.cu, csrc/flash_attention.cu), built with nvcc at first use
and loaded with ctypes. Importing the package builds nothing and needs no GPU.
"""

__version__ = "0.1.0"
