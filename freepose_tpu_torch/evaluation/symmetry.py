"""BOP object symmetry transformations.

Counterpart of bop_toolkit misc.get_symmetry_transformations (reference
bop_toolkit/bop_toolkit_lib/misc.py:44-91): expands a models_info.json entry
into the discrete × discretized-continuous set of {R, t} used by the
symmetry-aware errors (mssd / mspd in freepose_tpu_torch.evaluation.pose_error and
the rotation-drift sweep in evaluation.video_metrics).

A copy of freepose_tpu.evaluation.symmetry (numpy only):
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _axis_rotation(angle: float, axis: np.ndarray) -> np.ndarray:
    """Rodrigues rotation about an arbitrary (unnormalized) axis."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def get_symmetry_transformations(model_info: dict, max_sym_disc_step: float = 0.01) -> list[dict]:
    """models_info entry -> list of {"R": [3,3], "t": [3,1]} symmetry poses.

    Continuous symmetries are discretized so the farthest vertex travels at
    most `max_sym_disc_step` × diameter between consecutive rotations
    (reference misc.py:69-73 uses ceil(pi / max_sym_disc_step) steps)."""
    trans_disc = [{"R": np.eye(3), "t": np.zeros((3, 1))}]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.reshape(np.asarray(sym, np.float64), (4, 4))
        trans_disc.append({"R": m[:3, :3], "t": m[:3, 3].reshape(3, 1)})

    trans_cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], np.float64)
        offset = np.asarray(sym["offset"], np.float64).reshape(3, 1)
        steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / steps
        for i in range(steps):
            r = _axis_rotation(i * step, axis)
            trans_cont.append({"R": r, "t": -r @ offset + offset})

    out = []
    for td in trans_disc:
        if trans_cont:
            for tc in trans_cont:
                out.append({"R": tc["R"] @ td["R"], "t": tc["R"] @ td["t"] + tc["t"]})
        else:
            out.append(td)
    return out


def load_models_info(path: str | Path) -> dict:
    """models_info.json -> {obj_id(int): info dict} (BOP convention: string
    keys in the file, integer ids in code)."""
    with Path(path).open() as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}
