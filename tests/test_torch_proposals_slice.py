"""The static proposal slice through both packages' CLIs, on the CPU.

The JAX CLIs and the port's run in one process (as in
tests/test_torch_video_slice.py) under FREEPOSE_TINY_MODELS=1, on the same
.npz weights: GDINO_TEST (models/convert.py:random_grounding_dino_params),
SAM2_TEST (random_sam2_image_params), the JAX VIT_TEST DINOv2; fp32, plain
attention. The scene is a seeded BOP test split written here: 2 images of
96x128 with three painted objects each, their scene_camera / scene_gt and
visible masks.

* extract_proposals_ground with --detector grounding, gt-boxes and
  gt-masks, and with --topk 2 over --fine-bank and over
  --fine-features-dir: the same entries (scene,
  image, order) with the same mesh names, boxes within 1 px, RLE masks that
  differ in at most MASK_PX pixels (SAM2 logits near 0 may flip sign after
  fp32 sums in another order), scores within 1e-4. The grounding run's box
  threshold lies halfway between two detection scores of image 0, so that
  a few boxes pass on every image without one sitting on the threshold.
* extract_proposals_ground_video --detector grounding on the video slice
  test's 4-frame scene (tiny SAM2 video config): the same proposals, to
  the same tolerances.
* extract_retrieval_features then merge_features on 6-view template shards
  written here: the same [V, D] files and bank within 1e-4.
* io/npy_bank: the port's consolidated fine bank equals the JAX one, and
  each package's FineFeatureBank reads the other's with the same rows.
* Every ported entry point takes the JAX script's options plus --device.
"""
import importlib
import json
import re
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freepose_tpu.io.rle import decode_rle
from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from freepose_tpu_torch.models.convert import (random_grounding_dino_params, random_sam2_image_params,
                                               random_sam2_video_params, save_params)
from freepose_tpu_torch.models.grounding_dino import GDINO_TEST
from freepose_tpu_torch.models.sam2.model import SAM2_TEST
from freepose_tpu_torch.scripts.common import load_grounding_detector, tiny_sam2_video_config

REPO = Path(__file__).resolve().parents[1]
H, W, MASK_PX, VIEWS = 96, 128, 4, 6
MESHES = ["mesh_a", "mesh_b", "mesh_c", "mesh_d", "mesh_e", "mesh_f"]
OBJECTS = ((1, (10, 12, 40, 50), (220, 60, 40)), (3, (50, 30, 90, 80), (40, 90, 230)),
           (5, (85, 8, 120, 40), (60, 200, 80)))  # (obj_id, xyxy, colour)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the suite runs several files
    at once, one per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_proposals")
    rng = np.random.default_rng(0)
    scene = ws / "bop" / "tiny" / "test" / "000001"
    for sub in ("rgb", "mask_visib"):
        (scene / sub).mkdir(parents=True)
    cams, gts = {}, {}
    for fid in range(2):
        img = (rng.random((H, W, 3)) * 80).astype(np.uint8)
        gts[str(fid)] = []
        for k, (obj, (x0, y0, x1, y1), colour) in enumerate(OBJECTS):
            x0, x1 = x0 + 4 * fid, x1 + 4 * fid
            img[y0:y1, x0:x1] = colour
            mask = np.zeros((H, W), np.uint8)
            mask[y0:y1, x0:x1] = 255
            Image.fromarray(mask).save(scene / "mask_visib" / f"{fid:06d}_{k:06d}.png")
            gts[str(fid)].append({"obj_id": obj, "cam_R_m2c": np.eye(3).ravel().tolist(),
                                  "cam_t_m2c": [0.0, 0.0, 500.0]})
        Image.fromarray(img).save(scene / "rgb" / f"{fid:06d}.png")
        cams[str(fid)] = {"cam_K": [500.0, 0, W / 2, 0, 500.0, H / 2, 0, 0, 1], "depth_scale": 1.0}
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    (scene / "scene_gt.json").write_text(json.dumps(gts))

    np.save(ws / "bank.npy", rng.standard_normal((len(MESHES), JAX_VIT_TEST.hidden_size)).astype(np.float32))
    (ws / "meshes.txt").write_text("\n".join(MESHES) + "\n")
    (ws / "fine").mkdir()
    for name in MESHES[:-1]:  # the last mesh has no file: a zero block
        np.save(ws / "fine" / f"{name.replace('_', '')}.npy",
                rng.standard_normal((VIEWS, JAX_VIT_TEST.hidden_size)).astype(np.float32))
    save_params(random_grounding_dino_params(GDINO_TEST, seed=0), ws / "gdino.npz")
    save_params(random_sam2_image_params(SAM2_TEST, seed=0), ws / "sam2.npz")
    save_params(random_sam2_video_params(tiny_sam2_video_config(), seed=0), ws / "sam2_video.npz")
    dino = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    save_params(jax.tree_util.tree_map(np.asarray, dino), ws / "dinov2.npz")
    return ws


def _run_jax_cli(module: str, argv: list[str], monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", [module, *argv])
    importlib.import_module(module).main()


def _assert_same_proposals(ours: list[dict], ref: list[dict], keys=("scene_id", "image_id")):
    assert len(ours) == len(ref) > 0
    for p, r in zip(ours, ref):
        assert all(p[k] == r[k] for k in keys) and p["mesh"] == r["mesh"], (p, r)
        np.testing.assert_allclose(p["score"], r["score"], atol=1e-4)
        np.testing.assert_allclose(p["bbox"], r["bbox"], atol=1)
        differ = int((decode_rle(p["segmentation"]) != decode_rle(r["segmentation"])).sum())
        assert differ <= MASK_PX, f"{differ} mask pixels differ"


def _box_threshold(image: np.ndarray, weights, keep: int = 3) -> float:
    """Halfway between the keep-th and (keep+1)-th detection score."""
    _, scores = load_grounding_detector(str(weights), "cpu").detect(image, box_threshold=-1.0)
    s = np.sort(scores)[::-1]
    return float((s[keep - 1] + s[keep]) / 2)


def _static_argv(ws, out: str, detector: str, *extra: str) -> list[str]:
    return ["--dataset", str(ws / "bop" / "tiny"), "--bank", str(ws / "bank.npy"),
            "--filelist", str(ws / "meshes.txt"), "--out-dir", str(ws / out), "--detector", detector,
            "--weights", str(ws / "dinov2.npz"), "--sam2-weights", str(ws / "sam2.npz"),
            "--grounding-weights", str(ws / "gdino.npz"), "--min-mask-px", "30", *extra]


def _run_static_both(ws, monkeypatch, tag: str, detector: str, *extra: str):
    from freepose_tpu_torch.scripts import extract_proposals_ground

    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    for out in (f"jax_{tag}", f"torch_{tag}"):
        (ws / out).mkdir()
    _run_jax_cli("scripts.extract_proposals_ground", _static_argv(ws, f"jax_{tag}", detector, *extra), monkeypatch)
    extract_proposals_ground.main(_static_argv(ws, f"torch_{tag}", detector, *extra) + ["--device", "cpu"])
    (ref_path,) = (ws / f"jax_{tag}").iterdir()
    (path,) = (ws / f"torch_{tag}").iterdir()
    assert path.name == ref_path.name  # proposals_filename
    return json.loads(path.read_text()), json.loads(ref_path.read_text())


@pytest.mark.parametrize("detector", ["gt-masks", "gt-boxes", "grounding"])
def test_static_proposals_cli_matches_jax(workspace, monkeypatch, detector):
    ws = workspace
    extra = []
    if detector == "grounding":
        monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
        image = np.asarray(Image.open(ws / "bop" / "tiny" / "test" / "000001" / "rgb" / "000000.png"))
        extra = ["--box-threshold", repr(_box_threshold(image, ws / "gdino.npz"))]
    ours, ref = _run_static_both(ws, monkeypatch, detector, detector, *extra)
    _assert_same_proposals(ours, ref)
    assert {p["image_id"] for p in ref} == {0, 1}
    if detector != "grounding":
        assert len(ref) == 2 * len(OBJECTS)


@pytest.mark.parametrize("source", ["fine-bank", "fine-features-dir"])
def test_static_proposals_fine_rerank_matches_jax(workspace, monkeypatch, source):
    """--topk 2 over the candidates' per-view features: from the
    consolidated bank (io/npy_bank), or from one [V, D] .npy per mesh name."""
    from freepose_tpu_torch.io.npy_bank import consolidate_fine_features

    ws = workspace
    if source == "fine-bank":
        consolidate_fine_features(ws / "fine", MESHES, ws / "fine_bank")
        arg = ws / "fine_bank"
    else:
        arg = ws / "fine_by_name"
        arg.mkdir()
        for name in MESHES:  # every candidate needs its file here
            src = ws / "fine" / f"{name.replace('_', '')}.npy"
            np.save(arg / f"{name}.npy", np.load(src) if src.exists() else np.ones((VIEWS, JAX_VIT_TEST.hidden_size),
                                                                                     np.float32))
    ours, ref = _run_static_both(ws, monkeypatch, f"rerank_{source}", "gt-masks", "--topk", "2", f"--{source}",
                                 str(arg))
    _assert_same_proposals(ours, ref)


def test_video_proposals_cli_grounding_matches_jax(workspace, monkeypatch):
    from freepose_tpu_torch.scripts import extract_proposals_ground_video

    ws = workspace
    rng = np.random.default_rng(1)
    (ws / "frames").mkdir()
    for t in range(4):  # the video slice test's scene: two squares drifting over noise
        img = (rng.random((64, 64, 3)) * 80).astype(np.uint8)
        img[10 + t:34 + t, 6 + t:30 + t] = [220, 60, 40]
        img[30 - t:56 - t, 36:60] = [40, 90, 230]
        Image.fromarray(img).save(ws / "frames" / f"{t:05d}.png")
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    thr = _box_threshold(np.asarray(Image.open(ws / "frames" / "00000.png")), ws / "gdino.npz", keep=2)
    argv = ["--video-dir", str(ws / "frames"), "--bank", str(ws / "bank.npy"), "--filelist", str(ws / "meshes.txt"),
            "--detector", "grounding", "--grounding-weights", str(ws / "gdino.npz"),
            "--sam2-weights", str(ws / "sam2_video.npz"), "--weights", str(ws / "dinov2.npz"),
            "--box-threshold", repr(thr), "--min-mask-px", "30"]
    _run_jax_cli("scripts.extract_proposals_ground_video", argv + ["--out", str(ws / "video_jax.json")],
                 monkeypatch)
    extract_proposals_ground_video.main(argv + ["--out", str(ws / "video_torch.json"), "--device", "cpu"])
    ref = json.loads((ws / "video_jax.json").read_text())
    ours = json.loads((ws / "video_torch.json").read_text())
    _assert_same_proposals(ours, ref, keys=("track_id", "image_id"))


def test_retrieval_bank_clis_match_jax(workspace, monkeypatch):
    from freepose_tpu_torch.datasets.template import write_shard
    from freepose_tpu_torch.scripts import extract_retrieval_features, merge_features

    ws = workspace
    rng = np.random.default_rng(2)
    (ws / "shards").mkdir()
    packs = {}
    for i, name in enumerate(MESHES[:3]):
        rgb = rng.random((VIEWS, 84, 84, 3)).astype(np.float32)
        depth = np.zeros((VIEWS, 84, 84), np.float32)
        for k in range(VIEWS):
            depth[k, 10 + 3 * k:60 + i, 20:70 - 2 * k] = 0.5 + 0.01 * k
        packs[name] = (rgb, depth)
    write_shard(ws / "shards" / "shard-000000.tar", packs)
    (ws / "bank_meshes.txt").write_text("\n".join(MESHES[:4]) + "\n")  # the 4th has no views: a zero row
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.setenv("FREEPOSE_TEMPLATE_VIEWS", str(VIEWS))
    feats = ["--wds-dir", str(ws / "shards"), "--filelist", str(ws / "meshes3.txt"), "--weights",
             str(ws / "dinov2.npz"), "--batch-size", "4"]
    (ws / "meshes3.txt").write_text("\n".join(MESHES[:3]) + "\n")
    _run_jax_cli("scripts.extract_retrieval_features", feats + ["--out", str(ws / "feats_jax")], monkeypatch)
    extract_retrieval_features.main(feats + ["--out", str(ws / "feats_torch"), "--device", "cpu"])
    for name in MESHES[:3]:
        clean = name.replace("_", "")
        ours, ref = np.load(ws / "feats_torch" / f"{clean}.npy"), np.load(ws / "feats_jax" / f"{clean}.npy")
        assert ours.shape == ref.shape == (VIEWS, JAX_VIT_TEST.hidden_size) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, atol=1e-4)
    merge = ["--filelist", str(ws / "bank_meshes.txt")]
    _run_jax_cli("scripts.merge_features", merge + ["--features-dir", str(ws / "feats_jax"), "--out",
                                                     str(ws / "bank_jax.npy")], monkeypatch)
    merge_features.main(merge + ["--features-dir", str(ws / "feats_torch"), "--out", str(ws / "bank_torch.npy")])
    ours, ref = np.load(ws / "bank_torch.npy"), np.load(ws / "bank_jax.npy")
    assert ours.shape == ref.shape == (4, JAX_VIT_TEST.hidden_size) and not ref[3].any()
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_fine_bank_round_trip_matches_jax(workspace):
    from freepose_tpu.io.npy_bank import FineFeatureBank as JaxBank
    from freepose_tpu.io.npy_bank import consolidate_fine_features as jax_consolidate
    from freepose_tpu_torch.io.npy_bank import FineFeatureBank, consolidate_fine_features

    ws = workspace
    consolidate_fine_features(ws / "fine", MESHES, ws / "rt_torch")
    jax_consolidate(ws / "fine", MESHES, ws / "rt_jax")
    np.testing.assert_array_equal(np.load(ws / "rt_torch.bin.npy"), np.load(ws / "rt_jax.bin.npy"))
    assert json.loads((ws / "rt_torch.json").read_text()) == json.loads((ws / "rt_jax.json").read_text())
    rows = np.array([4, 0, 5, 2])
    ours, ref = FineFeatureBank(ws / "rt_jax"), JaxBank(ws / "rt_torch")
    np.testing.assert_array_equal(ours.gather(rows), ref.gather(rows))
    ours.prefetch(rows[:2])
    for _ in range(200):  # the worker thread's block, once it has landed
        if tuple(int(i) for i in rows[:2]) in ours._prefetched:
            break
        time.sleep(0.01)
    np.testing.assert_array_equal(ours.gather(rows[:2]), ref.gather(rows[:2]))
    assert ours.shape == ref.shape == (len(MESHES), VIEWS, JAX_VIT_TEST.hidden_size)
    assert not ours.gather(np.array([5])).any()  # the missing mesh: zeros


PORTED_CLIS = sorted(p.stem for p in (REPO / "freepose_tpu_torch" / "scripts").glob("*.py")
                     if p.stem not in ("__init__", "common"))


def _flags(path) -> set[str]:
    """The options a script's parser takes, from its source."""
    src = path.read_text()
    flags = set(re.findall(r'add_argument\(\s*(?:"-[a-z]",\s*)?"(--[a-z0-9_-]+)"', src))
    if "add_shard_args(ap)" in src:
        flags |= {"--shard-index", "--shard-count"}
    if "add_device_arg(ap)" in src:
        flags.add("--device")
    return flags


@pytest.mark.parametrize("name", PORTED_CLIS)
def test_cli_flags_equal_the_jax_scripts(name):
    """Every ported entry point takes the JAX script's options, plus --device
    where it runs a model (merge_features, filter_predictions, eval_videos,
    sav_evaluator, convert_weights, prepare_weights, resize_meshes,
    merge_results and vis_detections_video run on the host only)."""
    ours, ref = _flags(REPO / "freepose_tpu_torch" / "scripts" / f"{name}.py"), _flags(REPO / "scripts" / f"{name}.py")
    host_only = ("merge_features", "filter_predictions", "eval_videos", "sav_evaluator", "convert_weights",
                 "prepare_weights", "resize_meshes", "merge_results", "vis_detections_video")
    assert ours - ref == ({"--device"} if name not in host_only else set())
    assert ref <= ours
