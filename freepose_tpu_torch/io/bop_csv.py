"""BOP result CSV read/write.

Byte-compatible with the CSVs the reference pipeline emits and bop_toolkit
consumes: columns scene_id,im_id,obj_id,score,R,t,bbox_visib,scale,time with
R row-major 9 floats and t 3 floats, both space-separated (reference
scripts/dino_inference.py:56-130; reader at
bop_toolkit/bop_toolkit_lib/inout.py:297). Static BOP datasets store t in
millimetres, video CSVs in metres — callers pass `t_scale`.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pandas as pd

COLUMNS = ["scene_id", "im_id", "obj_id", "score", "R", "t", "bbox_visib", "scale", "time"]


@dataclasses.dataclass
class PoseResult:
    scene_id: int
    im_id: int
    obj_id: int | str
    score: float
    R: np.ndarray  # [3, 3]
    t: np.ndarray  # [3], metres
    bbox_visib: np.ndarray | None = None  # [4] xywh
    scale: float = 1.0
    time: float = -1.0


def write_results_csv(results: list[PoseResult], path: str | Path, t_scale: float = 1.0) -> None:
    rows = {c: [] for c in COLUMNS}
    for r in results:
        rows["scene_id"].append(int(r.scene_id))
        rows["im_id"].append(int(r.im_id))
        rows["obj_id"].append(r.obj_id)
        rows["score"].append(float(r.score))
        rows["R"].append(" ".join(str(float(x)) for x in np.asarray(r.R).reshape(-1)))
        rows["t"].append(" ".join(str(float(x) * t_scale) for x in np.asarray(r.t).reshape(-1)))
        bbox = r.bbox_visib if r.bbox_visib is not None else np.full(4, -1.0)
        rows["bbox_visib"].append(" ".join(str(float(x)) for x in np.asarray(bbox).reshape(-1)))
        rows["scale"].append(float(r.scale))
        rows["time"].append(float(r.time))
    pd.DataFrame(rows).to_csv(Path(path), index=False, header=True)


def read_results_csv(path: str | Path, t_scale: float = 1.0) -> list[PoseResult]:
    df = pd.read_csv(Path(path))
    out = []
    for _, row in df.iterrows():
        r = np.fromstring(str(row["R"]), sep=" ", dtype=np.float64).reshape(3, 3)
        t = np.fromstring(str(row["t"]), sep=" ", dtype=np.float64) / t_scale
        bbox = None
        if "bbox_visib" in df.columns and isinstance(row.get("bbox_visib"), str):
            bbox = np.fromstring(row["bbox_visib"], sep=" ", dtype=np.float64)
        out.append(
            PoseResult(
                scene_id=int(row["scene_id"]),
                im_id=int(row["im_id"]),
                obj_id=row["obj_id"],
                score=float(row["score"]),
                R=r,
                t=t,
                bbox_visib=bbox,
                scale=float(row.get("scale", 1.0)),
                time=float(row.get("time", -1.0)),
            )
        )
    return out


def results_to_pose_arrays(results: list[PoseResult]) -> tuple[np.ndarray, np.ndarray]:
    """Stack a track's rotations/translations for device-side smoothing/eval."""
    rs = np.stack([r.R for r in results])
    ts = np.stack([r.t for r in results])
    return rs, ts


def merge_result_csvs(paths: list[str | Path], out_path: str | Path) -> None:
    """Concatenate per-shard result CSVs into one (replaces the reference's
    merge_results.py SLURM-shard recombination, scripts/merge_results.py:14-29)."""
    frames = [pd.read_csv(Path(p)) for p in paths]
    pd.concat(frames, ignore_index=True).to_csv(Path(out_path), index=False, header=True)


def check_bop_results(path: str | Path) -> tuple[bool, str]:
    """Format conformance check (reference bop_toolkit_lib/inout.py:385-421,
    bop19 protocol): the file must parse, rotations must be 9 floats,
    translations 3, and every estimate of the same (scene, image) must report
    the SAME running time (the eval averages it per image)."""
    try:
        results = read_results_csv(path)
    except Exception as e:  # malformed file
        return False, f"Error when loading BOP results: {e}"
    times: dict = {}
    for r in results:
        if np.asarray(r.R).shape != (3, 3) or np.asarray(r.t).shape != (3,):
            return False, f"bad R/t shape for scene {r.scene_id} image {r.im_id}"
        key = (r.scene_id, r.im_id)
        if key in times:
            if abs(times[key] - r.time) > 0.001:
                return False, (
                    f"The running time for scene {r.scene_id} and image "
                    f"{r.im_id} is not the same for all estimates."
                )
        else:
            times[key] = r.time
    return True, "OK"
