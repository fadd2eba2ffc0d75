"""`propose_image` and `pose_frame`, the per-image functions the static CLIs
run and the benchmark's BOP cells call, give exactly the CLIs' rows.

A tiny BOP split written here (2 images of 96x128, three painted objects
each), FREEPOSE_TINY_MODELS=1 (GDINO_TEST, SAM2_TEST at 64², VIT_TEST) with
the models' seeded random weights, fp32 on the CPU. extract_proposals_ground
(grounding detector, its box threshold halfway between two scores) writes
its JSON; the same images through `propose_image`, with the CLI's detector,
SAM2 and extractor, give the same entries. render_templates then writes
8-view shards of a small mesh under every bank name, dino_inference writes
its CSV from that JSON, and `pose_frame` with the CLI's shard packs gives the
same rows (every column but the measured `time`).
"""
import argparse
import json

import numpy as np
import pytest
import torch
from PIL import Image

from freepose_tpu_torch.io.mesh import TriMesh, save_obj

H, W = 96, 128
MESHES = ["mesha", "meshb", "meshc", "meshd"]
OBJECTS = (((10, 12, 40, 50), (220, 60, 40)), ((50, 30, 90, 80), (40, 90, 230)), ((85, 8, 120, 40), (60, 200, 80)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("bop_steps")
    rng = np.random.default_rng(0)
    scene = ws / "bop" / "tiny" / "test" / "000001"
    for sub in ("rgb", "mask_visib"):
        (scene / sub).mkdir(parents=True)
    cams, gts = {}, {}
    for fid in range(2):
        img = (rng.random((H, W, 3)) * 80).astype(np.uint8)
        gts[str(fid)] = []
        for k, ((x0, y0, x1, y1), colour) in enumerate(OBJECTS):
            img[y0:y1, x0 + 4 * fid:x1 + 4 * fid] = colour
            mask = np.zeros((H, W), np.uint8)
            mask[y0:y1, x0 + 4 * fid:x1 + 4 * fid] = 255
            Image.fromarray(mask).save(scene / "mask_visib" / f"{fid:06d}_{k:06d}.png")
            gts[str(fid)].append({"obj_id": k + 1, "cam_R_m2c": np.eye(3).ravel().tolist(),
                                  "cam_t_m2c": [0.0, 0.0, 500.0]})
        Image.fromarray(img).save(scene / "rgb" / f"{fid:06d}.png")
        cams[str(fid)] = {"cam_K": [500.0, 0, W / 2, 0, 500.0, H / 2, 0, 0, 1], "depth_scale": 1.0}
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    (scene / "scene_gt.json").write_text(json.dumps(gts))
    from freepose_tpu_torch.models.dinov2 import VIT_TEST

    np.save(ws / "bank.npy", rng.standard_normal((len(MESHES), VIT_TEST.hidden_size)).astype(np.float32))
    (ws / "meshes.txt").write_text("\n".join(MESHES) + "\n")
    (ws / "meshes").mkdir()
    for i, name in enumerate(MESHES):
        u, v = np.meshgrid(np.linspace(0, 2 * np.pi, 12, endpoint=False), np.linspace(0.3, 2.8, 6), indexing="ij")
        verts = np.stack([np.sin(v) * np.cos(u), (0.6 + 0.1 * i) * np.sin(v) * np.sin(u), np.cos(v)], -1)
        verts = verts.reshape(-1, 3).astype(np.float32)
        faces = [[a * 6 + b, ((a + 1) % 12) * 6 + b, a * 6 + b + 1] for a in range(12) for b in range(5)]
        colors = np.random.default_rng(i).random(verts.shape).astype(np.float32)
        (ws / "meshes" / name).mkdir()
        save_obj(TriMesh(verts, np.asarray(faces, np.int32), colors).normalized(),
                 ws / "meshes" / name / f"{name}.obj")
    return ws


def _proposal_args(ws, threshold: float) -> list[str]:
    return ["--dataset", str(ws / "bop" / "tiny"), "--bank", str(ws / "bank.npy"), "--filelist",
            str(ws / "meshes.txt"), "--out-dir", str(ws / "props"), "--detector", "grounding", "--min-mask-px", "30",
            "--layer", "2", "--box-threshold", repr(threshold), "--device", "cpu"]


@pytest.fixture(scope="module")
def proposals(workspace):
    """The proposal CLI's JSON and the entries propose_image gives."""
    from freepose_tpu_torch.datasets.bop import BOPDataset
    from freepose_tpu_torch.scripts import extract_proposals_ground as epg
    from freepose_tpu_torch.scripts.common import load_dino_extractor, load_grounding_detector, \
        load_sam2_image_predictor

    ws = workspace
    mp = pytest.MonkeyPatch()
    mp.setenv("FREEPOSE_TINY_MODELS", "1")
    try:
        image = np.asarray(Image.open(ws / "bop" / "tiny" / "test" / "000001" / "rgb" / "000000.png"))
        _, scores = load_grounding_detector(None, "cpu").detect(image, box_threshold=-1.0)
        s = np.sort(scores)[::-1]
        threshold = float((s[2] + s[3]) / 2)
        (ws / "props").mkdir()
        epg.main(_proposal_args(ws, threshold))
        (path,) = (ws / "props").iterdir()
        cli = json.loads(path.read_text())

        args = argparse.Namespace(detector="grounding", grounding_weights=None, device="cpu", text_prompt="objects.",
                                  box_threshold=threshold, text_threshold=0.15)
        extractor = load_dino_extractor(None, device="cpu")
        bank = np.load(ws / "bank.npy").astype(np.float32)
        bank /= np.maximum(np.linalg.norm(bank, axis=-1, keepdims=True), 1e-12)
        predictor = load_sam2_image_predictor(None, "cpu")
        dataset = BOPDataset(str(ws / "bop" / "tiny"), "test")
        direct = []
        for i in range(len(dataset)):
            direct += epg.propose_image(dataset[i], lambda e: epg.detect(args, e),
                                        lambda im, b: epg.sam2_masks(predictor, im, b), extractor,
                                        torch.as_tensor(bank), MESHES, layer=2, min_mask_px=30)
    finally:
        mp.undo()
    return path, cli, json.loads(json.dumps(direct))


def test_propose_image_gives_the_cli_s_entries(proposals):
    _, cli, direct = proposals
    assert len(cli) > 0 and {p["image_id"] for p in cli} == {0, 1}
    assert direct == cli


def test_pose_frame_gives_the_cli_s_rows(workspace, proposals, tmp_path):
    from freepose_tpu_torch.datasets.bop import BOPDataset
    from freepose_tpu_torch.datasets.template import WebTemplateDataset
    from freepose_tpu_torch.io.bop_csv import read_results_csv, write_results_csv
    from freepose_tpu_torch.io.proposals_json import filter_by_frame, load_proposals
    from freepose_tpu_torch.pipeline.pose_estimator import CoarsePoseEstimator
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank
    from freepose_tpu_torch.scripts import dino_inference, render_templates
    from freepose_tpu_torch.scripts.common import load_dino_extractor

    ws = workspace
    path = proposals[0]
    mp = pytest.MonkeyPatch()
    mp.setenv("FREEPOSE_TINY_MODELS", "1")
    mp.setenv("FREEPOSE_TEMPLATE_VIEWS", "8")
    try:
        render_templates.main(["--mesh-dir", str(ws / "meshes"), "--filelist", str(ws / "meshes.txt"), "--out",
                               str(tmp_path / "shards"), "--n-poses", "8", "--resolution", "56", "--device", "cpu"])
        dino_inference.main(["--dataset", str(ws / "bop" / "tiny"), "--proposals", str(path), "--wds-dir",
                             str(tmp_path / "shards"), "--filelist", str(ws / "meshes.txt"), "--out",
                             str(tmp_path / "cli.csv"), "--layer", "2", "--device", "cpu"])
        extractor = load_dino_extractor(None, device="cpu")

        def feature_fn(imgs):
            return extractor(imgs, layer=2, feature_type="patch")

        bank = TemplateBank(feature_fn, cache_size=8, batch_size=128, device=extractor.device)
        estimator = CoarsePoseEstimator(feature_fn, bank)
        get_pack = dino_inference.shard_packs(WebTemplateDataset(tmp_path / "shards", MESHES), bank,
                                              extractor.device)
        props = load_proposals(path)
        dataset = BOPDataset(str(ws / "bop" / "tiny"), "test")
        rows = []
        for i in range(len(dataset)):
            entry = dataset[i]
            frame = filter_by_frame(props, entry["scene_id"], entry["frame_id"])
            if frame:
                rows += dino_inference.pose_frame(entry, frame, estimator, get_pack, extractor.device)
    finally:
        mp.undo()
    write_results_csv(rows, tmp_path / "direct.csv", t_scale=1000.0)
    cli = read_results_csv(tmp_path / "cli.csv", t_scale=1000.0)
    ours = read_results_csv(tmp_path / "direct.csv", t_scale=1000.0)
    assert len(cli) == len(ours) == len(proposals[1])
    for a, b in zip(ours, cli):
        assert (a.scene_id, a.im_id, a.obj_id, a.score, a.scale) == (b.scene_id, b.im_id, b.obj_id, b.score, b.scale)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)
        np.testing.assert_array_equal(a.bbox_visib, b.bbox_visib)
