"""Per-BOP-dataset metadata: object ids, symmetric objects, splits, sizes.

A copy of freepose_tpu.datasets.bop_params (the bop_toolkit dataset_params
of the datasets the reference evaluates: BOP19 core and HOPE video): public
dataset facts as plain dicts, and DatasetParams with the standard BOP
directory layout of datasets/bop.py:BOPDataset."""
from __future__ import annotations

import dataclasses
from pathlib import Path

OBJ_IDS = {
    "lm": list(range(1, 16)),
    "lmo": [1, 5, 6, 8, 9, 10, 11, 12],
    "tless": list(range(1, 31)),
    "tudl": list(range(1, 4)),
    "icbin": list(range(1, 3)),
    "itodd": list(range(1, 29)),
    "hb": list(range(1, 34)),
    "ycbv": list(range(1, 22)),
    "hope": list(range(1, 29)),
}

# Objects with ambiguous views, evaluated with ADI instead of ADD
# (Hodan et al. ECCVW'16; reference dataset_params.py:94-110).
SYMMETRIC_OBJ_IDS = {
    "lm": [3, 7, 10, 11],
    "lmo": [10, 11],
    "tless": list(range(1, 31)),
    "tudl": [],
    "icbin": [1],
    "itodd": [2, 3, 4, 5, 7, 8, 9, 11, 12, 14, 17, 18, 19, 23, 24, 25, 27, 28],
    "hb": [6, 10, 11, 12, 13, 14, 18, 24, 29],
    "ycbv": [1, 13, 14, 16, 18, 19, 20, 21],
    "hope": None,  # not defined by BOP
}

TEST_SCENE_IDS = {
    "lm": list(range(1, 16)),
    "lmo": [2],
    "tless": list(range(1, 21)),
    "tudl": list(range(1, 4)),
    "icbin": list(range(1, 4)),
    "itodd": [1],
    "hb": [3, 5, 13],
    "ycbv": list(range(48, 60)),
    "hope": list(range(0, 10)),
}

IM_SIZE = {
    "lm": (640, 480),
    "lmo": (640, 480),
    "tless": (720, 540),  # primesense test sensor
    "tudl": (640, 480),
    "icbin": (640, 480),
    "itodd": (1280, 960),
    "hb": (640, 480),
    "ycbv": (640, 480),
    "hope": (1920, 1080),
}


@dataclasses.dataclass(frozen=True)
class DatasetParams:
    name: str
    obj_ids: list
    symmetric_obj_ids: list | None
    test_scene_ids: list
    im_size: tuple
    base_path: Path
    model_type: str | None = None

    @property
    def split_path(self) -> Path:
        return self.base_path / self.name / "test"

    @property
    def models_path(self) -> Path:
        suffix = f"models_{self.model_type}" if self.model_type else "models"
        return self.base_path / self.name / suffix

    @property
    def models_info_path(self) -> Path:
        return self.models_path / "models_info.json"


def get_dataset_params(datasets_path: str | Path, name: str, model_type: str | None = None) -> DatasetParams:
    if name not in OBJ_IDS:
        raise KeyError(f"unknown BOP dataset {name!r}; known: {sorted(OBJ_IDS)}")
    if name == "tless" and model_type is None:
        model_type = "cad"  # reference dataset_params.py:113-114
    return DatasetParams(
        name=name,
        obj_ids=OBJ_IDS[name],
        symmetric_obj_ids=SYMMETRIC_OBJ_IDS[name],
        test_scene_ids=TEST_SCENE_IDS[name],
        im_size=IM_SIZE[name],
        base_path=Path(datasets_path),
        model_type=model_type,
    )
