"""The scale slice through both packages' CLIs, on the CPU.

compute_scale_video, compute_scale --use-depth and generate_depth_zoe, JAX
CLI and port CLI in one process (the hash tokenizer's str hash is salted per
process), FREEPOSE_TINY_MODELS=1, on the same inputs: a seeded 4-frame video
with two tracked objects and a proposal JSON, a one-scene BOP dataset, a
seeded 30-name prior, and one .npz each of CLIP_TEST and DEPTH_TEST
parameters in the JAX layout (seeded by models/convert.py:random_jax_params).
Both run fp32 with plain attention.

Tolerances: scales rtol 1e-4 (fp32 depth agrees to ~1e-6 between the
packages; the pointcloud masks, components and erosions are identical, and
the kNN picks the same prior rows); depth PNGs within one uint16 step (the
same depth rounded to 1/65535 of max_depth can land one step apart).
"""
import json
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from freepose_tpu_torch.io.proposals_json import proposal_entry, save_proposals
from freepose_tpu_torch.models.clip import CLIP_TEST, Clip
from freepose_tpu_torch.models.convert import random_jax_params, random_zoedepth_params, save_params, stack_scanned
from freepose_tpu_torch.models.zoedepth import DEPTH_TEST

N_FRAMES, H, W = 4, 64, 96
K_BOP = [120.0, 0, 48, 0, 120.0, 32, 0, 0, 1]


def _boxes(t: int):
    """Two objects drifting apart: xyxy boxes on frame t."""
    return [(10 + 2 * t, 12, 38 + 2 * t, 40), (56 - 2 * t, 20, 88 - 2 * t, 52)]


def _frame(rng, t: int) -> np.ndarray:
    img = (rng.random((H, W, 3)) * 80).astype(np.uint8)
    for (x1, y1, x2, y2), colour in zip(_boxes(t), ([220, 60, 40], [40, 90, 230])):
        img[y1:y2, x1:x2] = colour
    return img


def _mask(box) -> np.ndarray:
    x1, y1, x2, y2 = box
    m = np.zeros((H, W), bool)
    m[y1:y2, x1:x2] = True
    m[y1 + 3:y1 + 6, x1 + 4:x1 + 7] = False  # a hole
    m[y2 + 2, x1] = y2 + 2 < H  # a speckle: the largest component drops it
    return m


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_scale")
    rng = np.random.default_rng(0)
    (ws / "frames").mkdir()
    props = []
    for t in range(N_FRAMES):
        Image.fromarray(_frame(rng, t)).save(ws / "frames" / f"{t:05d}.png")
        for track, box in enumerate(_boxes(t)):
            p = proposal_entry(np.array(box), _mask(box), f"mesh_{track}", 0.9, 0, t)
            p["track_id"] = track
            props.append(p)
    save_proposals(props, ws / "video_props.json")

    scene = ws / "bop" / "test" / "000001"
    (scene / "rgb").mkdir(parents=True)
    bop_props = []
    for fid in range(2):
        Image.fromarray(_frame(rng, fid)).save(scene / "rgb" / f"{fid:06d}.png")
        for box in _boxes(fid):
            bop_props.append(proposal_entry(np.array(box), _mask(box), "mesh_0", 0.9, 1, fid))
    (scene / "scene_camera.json").write_text(json.dumps({str(f): {"cam_K": K_BOP, "depth_scale": 0.1}
                                                        for f in range(2)}))
    save_proposals(bop_props, ws / "bop_props.json")

    names = [f"object {i}" for i in range(30)]
    (ws / "prior.json").write_text(json.dumps({n: float(s) for n, s in zip(names, rng.uniform(0.03, 0.4, 30))}))
    with torch.device("meta"):
        clip = Clip(CLIP_TEST)
    save_params(stack_scanned(random_jax_params(clip, seed=1), "layers", "layer"), ws / "clip.npz")
    save_params(random_zoedepth_params(DEPTH_TEST, seed=2), ws / "depth.npz")
    return ws


def _run_jax_cli(module: str, argv: list[str], monkeypatch) -> None:
    import importlib

    monkeypatch.setattr(sys, "argv", [module, *argv])
    importlib.import_module(module).main()


@pytest.mark.parametrize("with_depth", [True, False])
def test_compute_scale_video_matches_jax(workspace, monkeypatch, with_depth):
    from freepose_tpu_torch.scripts import compute_scale_video

    ws = workspace
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    argv = ["--video-dir", str(ws / "frames"), "--proposals", str(ws / "video_props.json"),
            "--scale-file", str(ws / "prior.json"), "--clip-weights", str(ws / "clip.npz"), "--query-k", "11"]
    if with_depth:
        argv += ["--depth-weights", str(ws / "depth.npz")]
    _run_jax_cli("scripts.compute_scale_video", argv + ["--out", str(ws / "video_jax.json")], monkeypatch)
    compute_scale_video.main(argv + ["--out", str(ws / "video_torch.json"), "--device", "cpu"])

    ref = json.loads((ws / "video_jax.json").read_text())
    ours = json.loads((ws / "video_torch.json").read_text())
    assert len(ours) == len(ref) == 2 * N_FRAMES
    for o, r in zip(ours, ref):
        assert (o["track_id"], o["image_id"], o["segmentation"]) == (r["track_id"], r["image_id"], r["segmentation"])
        np.testing.assert_allclose(o["scale"], r["scale"], rtol=1e-4)
    per_track = {}
    for o in ours:
        per_track.setdefault(o["track_id"], set()).add(o["scale"])
    assert all(len(s) == 1 for s in per_track.values()), "one scale per track"
    assert all(np.isfinite(o["scale"]) and o["scale"] > 0 for o in ours)


def test_compute_scale_with_depth_matches_jax(workspace, monkeypatch, tmp_path):
    """--use-depth on depth_pred PNGs (two proposals per frame, so the depth
    correction runs)."""
    from freepose_tpu_torch.scripts import compute_scale

    ws = workspace
    bop = tmp_path / "bop"
    shutil.copytree(ws / "bop", bop, ignore=shutil.ignore_patterns("*_metadata.json"))
    rng = np.random.default_rng(3)
    (bop / "test" / "000001" / "depth_pred").mkdir()
    for fid in range(2):
        pred = (20000 + rng.integers(0, 2000, (H, W))).astype(np.uint16)
        Image.fromarray(pred).save(bop / "test" / "000001" / "depth_pred" / f"{fid:06d}.png")
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    argv = ["--dataset", str(bop), "--split", "test", "--proposals", str(ws / "bop_props.json"),
            "--scale-file", str(ws / "prior.json"), "--clip-weights", str(ws / "clip.npz"), "--use-depth"]
    _run_jax_cli("scripts.compute_scale", argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    compute_scale.main(argv + ["--out", str(tmp_path / "torch.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    ours = json.loads((tmp_path / "torch.json").read_text())
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert (o["image_id"], o["bbox"]) == (r["image_id"], r["bbox"])
        assert np.isfinite(o["scale"]) and o["scale"] > 0
        np.testing.assert_allclose(o["scale"], r["scale"], rtol=1e-4)


def test_generate_depth_zoe_matches_jax(workspace, monkeypatch, tmp_path):
    from freepose_tpu_torch.scripts import generate_depth_zoe

    ws = workspace
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    for name in ("jax", "torch"):
        shutil.copytree(ws / "bop", tmp_path / name, ignore=shutil.ignore_patterns("*_metadata.json"))
    argv = ["--split", "test", "--weights", str(ws / "depth.npz")]
    _run_jax_cli("scripts.generate_depth_zoe", argv + ["--dataset", str(tmp_path / "jax")], monkeypatch)
    generate_depth_zoe.main(argv + ["--dataset", str(tmp_path / "torch"), "--device", "cpu"])
    for fid in range(2):
        ref, ours = (np.asarray(Image.open(tmp_path / name / "test" / "000001" / "depth_pred" / f"{fid:06d}.png"))
                     for name in ("jax", "torch"))
        assert ours.dtype == ref.dtype == np.uint16 and ours.shape == ref.shape == (H, W)
        assert ours.max() > 0
        assert int(np.abs(ours.astype(np.int64) - ref.astype(np.int64)).max()) <= 1
