"""ctypes binding to the native C++ connected-components library.

Counterpart of freepose_tpu.ops.cc_native: union-find connected components
on the host, for mask postprocessing that never touches the device
(models/sam2/transforms.py:postprocess_masks with use_native=True), with the
contract of the device version (ops/connected_components.py): labels are
the smallest linear index of each 4-connected component, -1 on background.

The source is the port's own copy, csrc/connected_components.cpp, compiled
with g++ at first use into freepose_tpu_torch/_build/ by
ops/raster_native.py:build (named by a hash of the source and the flags)
and loaded with ctypes. A failed build raises: no caller switches quietly to
the device version. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "connected_components.cpp"

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    from freepose_tpu_torch.ops.raster_native import build

    with _lock:
        path = build(SOURCE)
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            u8p, i32p, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32
            lib.connected_components_batch.argtypes = [u8p, i32, i32, i32, i32p, i32p]
            lib.connected_components_batch.restype = None
            lib.remove_small_components.argtypes = [u8p, i32, i32, i32, i32, i32]
            lib.remove_small_components.restype = None
            _libs[path] = lib
        return lib


def _masks_u8(masks: np.ndarray) -> np.ndarray:
    m = np.ascontiguousarray(np.asarray(masks).astype(np.uint8))
    if m.ndim != 3:
        raise ValueError(f"masks must be [N, H, W], got shape {m.shape}")
    return m


def connected_components_batch(masks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[N, H, W] bool/uint8 -> (labels int32 [N, H, W]: the smallest linear
    index of each 4-connected component, -1 on background; areas int32
    [N, H, W]: the pixel's component area, 0 on background)."""
    lib = _load()
    m = _masks_u8(masks)
    n, h, w = m.shape
    labels = np.empty((n, h, w), np.int32)
    areas = np.empty((n, h, w), np.int32)
    lib.connected_components_batch(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
                                   labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                   areas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, areas


def remove_small_components(masks: np.ndarray, max_area: int, fill_holes: bool = True) -> np.ndarray:
    """[N, H, W] -> bool: background holes of at most max_area pixels filled
    (fill_holes), then foreground components of at most max_area removed."""
    lib = _load()
    m = _masks_u8(masks).copy()
    n, h, w = m.shape
    lib.remove_small_components(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, int(max_area),
                                int(fill_holes))
    return m.astype(bool)

