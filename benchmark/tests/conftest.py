"""Fixtures of the benchmark's own tests (run from the repository root:
`python -m pytest benchmark/tests -q`): a copy of the benchmark folder with a
tiny configuration and cell that the harness drives on the CPU in seconds."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FULL = "video-hieraL-dinov2L"


def tiny_config() -> dict:
    cfg = json.loads((BENCH / "configs" / f"{FULL}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["name"] = "tiny"
    cfg["sam2"] = {
        "image_size": 64, "mem_grid": 4, "fpn_dim": 128,
        "hiera": {"embed_dim": 8, "blocks_per_stage": [1, 1, 1, 1], "embed_dim_per_stage": [8, 16, 32, 64],
                  "heads_per_stage": [1, 2, 4, 8], "window_size_per_stage": [4, 4, 4, 4],
                  "global_attention_blocks": [9], "window_pos_bg_size": [2, 2], "query_stride": 2,
                  "num_query_pool_stages": 3, "mlp_ratio": 4.0},
        "prompt": {"hidden_size": 128, "image_size": 64, "patch_size": 16, "mask_input_channels": 16},
        "decoder": {"hidden_size": 128, "num_heads": 2, "mlp_dim": 32, "iou_head_hidden": 128},
        "memory": {"hidden_size": 128, "num_layers": 2, "num_heads": 1, "downsample_rate": 1, "ff_hidden": 32,
                   "rope_feat_size": 4, "mem_dim": 64, "num_maskmem": 7, "max_obj_ptrs": 16, "enc_hidden": 128,
                   "fuser_layers": 2, "fuser_intermediate": 32, "fuser_kernel": 7},
    }
    vit = {"hidden_size": 64, "num_layers": 3, "num_heads": 4, "patch_size": 14, "num_registers": 4,
           "mlp_ratio": 4.0, "image_size": 56}
    cfg["dinov2_l"], cfg["dinov2_b"] = dict(vit), dict(vit)
    cfg["refine"].update(feature_layer=2, template_res=56, n_coarse_poses=8, n_fine_poses=200, n_neighbors=8,
                         neighborhood_deg=40.0, fine_cache=16)
    cfg["mesh"] = {"n_u": 16, "n_v": 8}
    cfg["video"].update(frames=12, height=72, width=128, object_res=32)
    return cfg


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    """A copy of benchmark/ holding the tiny configuration and cell."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    cell = json.loads((BENCH / "workloads" / "video.coupled.1obj.json").read_text())
    cell.update(name="tiny", config="tiny")
    cell["params"]["videos"] = 2
    (dst / "workloads" / "tiny.json").write_text(json.dumps(cell))
    return dst


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)

