"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel source under freepose_tpu_torch/csrc/ exposes a plain C entry
point. At first use it is compiled for Hopper (sm_90a) into
freepose_tpu_torch/_build/ (git-ignored), named by a hash of the source, the
shared headers (csrc/*.cuh) and the flags so an edit rebuilds, and loaded
with ctypes. Nothing here runs at import time: this module imports on
machines without nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# Per-kernel extra nvcc flags. raster_tile: no FMA contraction, so the edge
# functions and interpolation round exactly as the plain PyTorch version does
# (a fused a*b - c*d can flip seam pixels in or out of coverage).
EXTRA_FLAGS = {
    "raster_tile": ["--fmad=false"],
    "flash_attention": [],
    "flash_attention_sm90": [],
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(name: str) -> list[str]:
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    """The built library of `name`, named by a hash of its source, the
    shared headers (csrc/*.cuh) and the flags."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    text = b"".join(src.read_bytes() for src in sources)
    digest = hashlib.sha256(text + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: list[str]) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc process per
    source, all started together. Returns the compiler output per name;
    raises RuntimeError naming the first source that failed."""
    started = {n: _start_build(n) for n in names}
    logs = {}
    failed = []
    for name, job in started.items():
        if job is None:
            logs[name] = "cached"
            continue
        proc, tmp, out = job
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic publish: readers only see whole files
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
