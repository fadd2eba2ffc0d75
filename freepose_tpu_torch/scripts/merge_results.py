"""Concatenate per-shard result CSVs (one per --shard-index of a sharded
CLI) into one BOP CSV. Runs on the host only.

Usage: python -m freepose_tpu_torch.scripts.merge_results --results-dir R --out merged.csv
"""
from __future__ import annotations

import argparse
from pathlib import Path

from freepose_tpu_torch.io.bop_csv import merge_result_csvs


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", required=True)
    ap.add_argument("--pattern", default="*.csv")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    paths = sorted(Path(args.results_dir).glob(args.pattern))
    if not paths:
        raise SystemExit(f"no CSVs matching {args.pattern} in {args.results_dir}")
    merge_result_csvs(paths, args.out)
    print(f"merged {len(paths)} CSVs -> {args.out}")


if __name__ == "__main__":
    main()
