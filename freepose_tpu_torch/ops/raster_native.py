"""ctypes binding to the native C++ host rasterizer.

Counterpart of freepose_tpu.ops.raster_native: the eval-side renderer on
hosts with no GPU (BOP-style `vsd` visibility masks and `cus` silhouettes),
mirroring the reference's external C++ bop_renderer
(bop_toolkit/bop_toolkit_lib/renderer_cpp.py:12-66), with the conventions of
the device rasterizer: OpenCV camera, +0.5 pixel centres, no culling, a
1e-5·|area| seam tolerance, perspective-correct 1/z, first-face-wins depth
ties.

The source is the port's own copy, csrc/raster_native.cpp. At first use it
is compiled with g++ into freepose_tpu_torch/_build/ (git-ignored), named by
a hash of the source and the flags so an edit rebuilds, and loaded with
ctypes. A failed build raises: nothing switches quietly to another renderer.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "raster_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The JAX package's csrc/Makefile flags: the same compiler and flags give
# the same float operations, so both packages' renders agree bit for bit.
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(source: Path = SOURCE) -> Path:
    """The built library of `source`, named by a hash of it and the flags."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libraster_native-{digest}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile `source` with g++ unless it is built already; returns the
    library's path. Raises RuntimeError with the compiler's output if the
    build fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run for {source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic publish: readers only see whole files
    return out


def _load() -> ctypes.CDLL:
    with _lock:
        path = build(SOURCE)
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32 = ctypes.c_int32
            lib.rasterize_mesh_batch.argtypes = [
                f32p, i32,  # vertices
                ctypes.POINTER(ctypes.c_int32), i32,  # faces
                f32p, i32,  # poses
                f32p,  # intrinsics
                f32p,  # colors (nullable)
                i32, i32,  # height, width
                ctypes.c_float, ctypes.c_float,  # znear, ambient
                f32p, f32p,  # out depth, out rgb (nullable)
            ]
            lib.rasterize_mesh_batch.restype = None
            _libs[path] = lib
        return lib


def rasterize_native(
    vertices: np.ndarray,  # [V, 3] float32 object-space
    faces: np.ndarray,  # [F, 3] int32
    poses: np.ndarray,  # [P, 4, 4] camera-from-object
    k: np.ndarray,  # [3, 3]
    colors: np.ndarray | None = None,  # [V, 3] in [0,1]
    height: int = 420,
    width: int | None = None,
    znear: float = 1e-4,
    ambient: float = 2.0,
) -> tuple[np.ndarray | None, np.ndarray]:
    """-> (rgb [P, H, W, 3] or None when colors is None, depth [P, H, W])."""
    lib = _load()
    width = width if width is not None else height
    v = np.ascontiguousarray(vertices, np.float32).reshape(-1, 3)
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    p = np.ascontiguousarray(poses, np.float32).reshape(-1, 4, 4)
    kk = np.ascontiguousarray(k, np.float32).reshape(3, 3)
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError(f"face indices outside [0, {v.shape[0]})")
    n_poses = p.shape[0]
    depth = np.empty((n_poses, height, width), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    if colors is not None:
        c = np.ascontiguousarray(colors, np.float32).reshape(-1, 3)
        if c.shape[0] != v.shape[0]:
            raise ValueError(f"{c.shape[0]} colours for {v.shape[0]} vertices")
        rgb = np.empty((n_poses, height, width, 3), np.float32)
        rgb_ptr, col_ptr = rgb.ctypes.data_as(f32p), c.ctypes.data_as(f32p)
    else:
        rgb = None
        rgb_ptr, col_ptr = f32p(), f32p()
    lib.rasterize_mesh_batch(
        v.ctypes.data_as(f32p), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
        p.ctypes.data_as(f32p), n_poses,
        kk.ctypes.data_as(f32p),
        col_ptr, height, width,
        ctypes.c_float(znear), ctypes.c_float(ambient),
        depth.ctypes.data_as(f32p), rgb_ptr,
    )
    return rgb, depth
