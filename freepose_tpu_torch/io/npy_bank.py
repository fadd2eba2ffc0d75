"""Feature banks: the coarse [N, D] retrieval bank and the fine per-view
[N, V, D] bank as one memory-mapped blob.

A copy of freepose_tpu.io.npy_bank (it needs no JAX).

The reference's fine rerank does ~100 serial np.load calls per proposal
(reference scripts/extract_proposals_ground.py:147-160 — flagged in
SURVEY.md §3.1 as an explicit IO bottleneck). Here all per-mesh [V, D] files
consolidate once into a single fp16 memmap; per-query candidate blocks are
one strided read, optionally prefetched for the next frame on a worker
thread, and ship to HBM as one array.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np


def consolidate_fine_features(
    features_dir: str | Path, filelist: list[str], out_path: str | Path
) -> None:
    """Merge per-mesh [V, D] .npy files into <out>.bin (fp16 memmap) +
    <out>.json metadata. Missing meshes get zero rows."""
    features_dir = Path(features_dir)
    out_path = Path(out_path)
    first = None
    for name in filelist:
        p = features_dir / f"{name.replace('_', '')}.npy"
        if p.exists():
            first = np.load(p)
            break
    if first is None:
        raise FileNotFoundError(f"no feature files in {features_dir}")
    v, d = first.shape
    mm = np.lib.format.open_memmap(
        out_path.with_suffix(".bin.npy"), mode="w+", dtype=np.float16,
        shape=(len(filelist), v, d),
    )
    missing = 0
    for i, name in enumerate(filelist):
        p = features_dir / f"{name.replace('_', '')}.npy"
        if p.exists():
            feats = np.load(p).astype(np.float32)
            norms = np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12)
            mm[i] = (feats / norms).astype(np.float16)
        else:
            missing += 1
    mm.flush()
    out_path.with_suffix(".json").write_text(
        json.dumps({"n": len(filelist), "views": v, "dim": d, "missing": missing})
    )


class FineFeatureBank:
    """Memory-mapped [N, V, D] per-view feature bank with candidate-block
    gather + background prefetch."""

    def __init__(self, path: str | Path):
        path = Path(path)
        self.meta = json.loads(path.with_suffix(".json").read_text())
        self.mm = np.load(path.with_suffix(".bin.npy"), mmap_mode="r")
        self._prefetched: dict = {}
        self._lock = threading.Lock()

    @property
    def shape(self):
        return self.mm.shape

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """[C] mesh row indices -> [C, V, D] float32 (L2-normalized rows)."""
        key = tuple(int(i) for i in indices)
        with self._lock:
            if key in self._prefetched:
                return self._prefetched.pop(key)
        return np.asarray(self.mm[np.asarray(indices)], dtype=np.float32)

    def prefetch(self, indices: np.ndarray) -> None:
        """Start loading a candidate block on a worker thread (overlaps the
        next frame's IO with current-frame compute)."""
        key = tuple(int(i) for i in indices)

        def work():
            block = np.asarray(self.mm[np.asarray(indices)], dtype=np.float32)
            with self._lock:
                self._prefetched[key] = block

        threading.Thread(target=work, daemon=True).start()
