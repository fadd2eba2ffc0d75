"""The host-only modules of the proposal slice's rest in the PyTorch port vs
the JAX package, on the CPU: datasets/bop_params.py (every dataset name and
model type, and the same error for an unknown name) and the
vis_detections_video CLI (the same JPEG bytes on a 3-frame video)."""
import json
import sys

import numpy as np
import pytest
from PIL import Image

from freepose_tpu.datasets import bop_params as jbop
from freepose_tpu_torch.datasets import bop_params as bop


@pytest.mark.parametrize("name", sorted(jbop.OBJ_IDS))
@pytest.mark.parametrize("model_type", [None, "cad", "eval"])
def test_dataset_params_match_jax(tmp_path, name, model_type):
    ours, ref = bop.get_dataset_params(tmp_path, name, model_type), jbop.get_dataset_params(tmp_path, name, model_type)
    for field in ("name", "obj_ids", "symmetric_obj_ids", "test_scene_ids", "im_size", "base_path", "model_type",
                  "split_path", "models_path", "models_info_path"):
        assert getattr(ours, field) == getattr(ref, field), field


def test_tables_and_the_unknown_name_error_match_jax(tmp_path):
    for table in ("OBJ_IDS", "SYMMETRIC_OBJ_IDS", "TEST_SCENE_IDS", "IM_SIZE"):
        assert getattr(bop, table) == getattr(jbop, table), table
    with pytest.raises(KeyError) as ours:
        bop.get_dataset_params(tmp_path, "nope")
    with pytest.raises(KeyError) as ref:
        jbop.get_dataset_params(tmp_path, "nope")
    assert str(ours.value) == str(ref.value)


def test_vis_detections_video_writes_the_jax_scripts_jpegs(tmp_path, monkeypatch):
    from freepose_tpu_torch.scripts import vis_detections_video
    from scripts import vis_detections_video as jax_cli

    rng = np.random.default_rng(0)
    (tmp_path / "frames").mkdir()
    for t in range(3):
        Image.fromarray((rng.random((40, 64, 3)) * 255).astype(np.uint8)).save(tmp_path / "frames" / f"{t:05d}.png")
    props = [{"image_id": 0, "bbox": [5, 4, 20, 18]}, {"image_id": 0, "bbox": [-3, 30, 80, 20]},
             {"image_id": 2, "bbox": [40.7, 2.2, 10.5, 30.9]}]
    (tmp_path / "props.json").write_text(json.dumps(props))
    args = ["--video-dir", str(tmp_path / "frames"), "--proposals", str(tmp_path / "props.json"), "--out-dir"]
    vis_detections_video.main(args + [str(tmp_path / "ours")])
    monkeypatch.setattr(sys, "argv", ["vis_detections_video", *args, str(tmp_path / "ref")])
    jax_cli.main()
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ours").iterdir()) == [f"{t:06d}.jpg" for t in range(3)]
    for n in names:
        assert (tmp_path / "ours" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes(), n
