"""Merge per-mesh [V, D] view features into the [N, D] retrieval bank.

Counterpart of the JAX package's scripts/merge_features.py, numpy only (no
device): the mean over each mesh's views, rows in filelist order, a zero row
for a mesh without features. A mesh's file is looked up as its name without
underscores first, then as its name.

Usage: python -m freepose_tpu_torch.scripts.merge_features \
         --features-dir FEATS --filelist meshes.txt --out bank.npy
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from freepose_tpu_torch.scripts.common import load_filelist


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--features-dir", required=True)
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    names = load_filelist(args.filelist)
    rows = []
    missing = 0
    dim = None
    for name in names:
        path = Path(args.features_dir) / f"{name.replace('_', '')}.npy"
        if not path.exists():
            path = Path(args.features_dir) / f"{name}.npy"
        if path.exists():
            feats = np.load(path)
            dim = feats.shape[-1]
            rows.append(feats.mean(axis=0))
        else:
            rows.append(None)
            missing += 1
    if dim is None:
        raise SystemExit("no feature files found")
    bank = np.stack([r if r is not None else np.zeros(dim, np.float32) for r in rows])
    np.save(args.out, bank.astype(np.float32))
    print(f"bank {bank.shape} -> {args.out} ({missing} meshes missing, zero rows)")


if __name__ == "__main__":
    main()
