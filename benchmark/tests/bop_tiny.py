"""The tiny BOP configuration and cells the benchmark's CPU tests drive."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.tests.conftest import tiny_config

BENCH = Path(__file__).resolve().parent.parent
FULL = "bop-gdinoB-hieraL-dinov2L"


def tiny_bop_config() -> dict:
    """bop-gdinoB-hieraL-dinov2L at tiny widths: GroundingDINO as the port's
    GDINO_TEST (a vocabulary that holds the prompt's ids), the tiny SAM2 and
    DINOv2 of the video cells' tests, a 50-row bank, 8-view packs on 72x96
    images. The crops stay 420², as the CLIs fix them."""
    cfg = copy.deepcopy(json.loads((BENCH / "configs" / f"{FULL}.json").read_text()))
    video = tiny_config()
    cfg["name"] = "tinybop"
    cfg["grounding_dino"].update(image_size=64, swin={
        "embed_dim": 8, "depths": [1, 1, 2], "num_heads": [1, 2, 4], "window_size": 4, "patch_size": 4,
        "mlp_ratio": 4.0, "out_stages": [1, 2]}, text={
        "vocab_size": 1100, "hidden_size": 24, "num_layers": 1, "num_heads": 2, "intermediate": 48,
        "max_position": 32, "type_vocab": 2})
    cfg["grounding_dino"]["transformer"].update(d_model=32, num_feature_levels=3, encoder_layers=1,
                                                decoder_layers=2, encoder_heads=4, decoder_heads=4, encoder_ffn=64,
                                                decoder_ffn=64, num_queries=12, max_text_len=16)
    cfg["sam2"] = {k: video["sam2"][k] for k in ("image_size", "mem_grid", "fpn_dim", "hiera", "prompt", "decoder")}
    cfg["dinov2_l"] = video["dinov2_l"]
    cfg["retrieval"].update(bank_rows=50, bank_dim=64, feature_layer=2, min_mask_px=10)
    cfg["pose"].update(n_coarse_poses=8, pack_batch=4, feature_layer=2)
    cfg["scene"].update(height=72, width=96, objects=2, object_res=24, meshes=2)
    cfg["mesh"] = {"n_u": 16, "n_v": 8}
    return cfg


# The pose stage's numbers, which the `bop_new_meshes` traffic adds to the
# proposals cell's (its cell is held back from BENCHMARK.json until its
# spread is measured on a card).
POSE_LIMITS = ("crop_err", "pack_feat_err", "pose_off_grid", "pose_gap", "score_err", "lift_err")


def tiny_bop_bench(dst: Path) -> Path:
    """A copy of benchmark/ under `dst` holding the tiny BOP cells
    `tinyprop` (traffic `bop_proposals`) and `tinynew` (`bop_new_meshes`),
    both from the proposals cell's workload file."""
    dst = dst / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "configs" / "tinybop.json").write_text(json.dumps(tiny_bop_config()))
    src = json.loads((BENCH / "workloads" / "bop.proposals.gdinoB.json").read_text())
    for name, traffic, params in (("tinyprop", "bop_proposals", {"images": 3, "k_min": 2, "k_max": 4}),
                                  ("tinynew", "bop_new_meshes", {"images": 2, "k": 2})):
        cell = copy.deepcopy(src)
        cell.update(name=name, config="tinybop", traffic=traffic, params=dict(loop="closed", **params))
        if traffic == "bop_new_meshes":
            cell["limits"].update({k: 0 for k in POSE_LIMITS})
        (dst / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return dst
