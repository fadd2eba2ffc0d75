"""The evaluation slice through both packages' CLIs, in-process on the CPU.

- eval_bop_pose --device cpu on a seeded 2-image BOP split at 96x72 (two GT
  objects per image, depth rendered at the GT poses, visib_fract, models
  info with a discrete symmetry), 3 estimates per image and every error
  (cus chamfer chamfer_proj vsd mssd mspd). Both packages render with the
  native C++ rasterizer on a host without an accelerator, so the score
  JSONs are equal.
- eval_videos on two methods' CSVs of one analytic video: the result CSVs
  are equal byte for byte.
- sav_evaluator on a DAVIS-layout and an SA-V-layout video: the per-video
  CSV and the printed lines are equal.
- vos_inference with FREEPOSE_TINY_MODELS=1 and one .npz of the tiny SAM2
  video weights (models/convert.py:random_sam2_video_params), palette PNGs
  with both objects on frame 0, and per-object PNG trees with
  --use-all-masks and an object that appears on frame 2. fp32 with plain
  attention in both; the output masks differ in at most MASK_PX pixels per
  frame (logits near 0 may flip sign after sums in another order, as in
  tests/test_torch_video_slice.py) and J&F agrees within 1e-2.
"""
import contextlib
import importlib
import io
import json
import sys

import numpy as np
import pytest
from PIL import Image
from scipy.spatial.transform import Rotation

from chip_smoke import write_ply  # the BOP model format, as the smoke's eval phase writes it
from freepose_tpu_torch.io.bop_csv import PoseResult, write_results_csv
from freepose_tpu_torch.io.mesh import TriMesh, save_obj
from freepose_tpu_torch.ops import raster_native

MASK_PX = 4
W, H = 96, 72
K = np.array([[110.0, 0.0, 47.3], [0.0, 110.0, 35.6], [0.0, 0.0, 1.0]])


def _blob(seed, n_lat=9, n_lon=12):
    """A bumpy sphere (216 faces), radius ~1, with vertex colours."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.1, 0.3)
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 1.0 + amp * np.sin(3 * ph) * np.sin(th)
            verts.append([r * np.sin(th) * np.cos(ph), 0.7 * r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    v = np.asarray(verts, np.float32)
    return TriMesh(v, np.asarray(faces, np.int32), rng.random((len(v), 3)).astype(np.float32)).normalized()


@pytest.fixture(scope="module")
def bop_ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_eval")
    half = {1: 0.05, 2: 0.04}  # half-extents in metres
    units = {obj: _blob(obj) for obj in half}  # unit half-extent
    (ws / "models").mkdir()
    for obj, m in units.items():
        write_ply(m.scaled(half[obj] * 1000.0), ws / "models" / f"obj_{obj:06d}.ply")  # mm
    (ws / "models" / "models_info.json").write_text(json.dumps({
        "1": {"diameter": 2 * half[1] * 1000.0 * 1.05},
        "2": {"diameter": 2 * half[2] * 1000.0 * 1.05, "symmetries_discrete": [
            [-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]},
    }))
    inf = ws / "inference"
    for name, obj in (("meshaaa", 1), ("meshbbb", 2)):
        (inf / name).mkdir(parents=True)
        save_obj(units[obj], inf / name / f"{name}.obj")

    scene = ws / "bop" / "test" / "000001"
    for d in ("rgb", "depth"):
        (scene / d).mkdir(parents=True)
    rng = np.random.default_rng(11)
    cams, gts, infos, results = {}, {}, {}, []
    for fid in range(2):
        poses = {}
        for obj, x in ((1, -0.04), (2, 0.05)):
            poses[obj] = (Rotation.random(random_state=10 * fid + obj).as_matrix(),
                          np.array([x, rng.uniform(-0.02, 0.02), 0.5 + 0.05 * obj]))
        depth = np.zeros((H, W), np.float32)
        masks = {}
        for obj, (r, t) in poses.items():
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3], pose[:3, 3] = r, t
            _, d = raster_native.rasterize_native(units[obj].scaled(half[obj]).vertices, units[obj].faces,
                                                  pose[None], K.astype(np.float32), height=H, width=W)
            masks[obj] = d[0] > 0
            depth = np.where((d[0] > 0) & ((depth == 0) | (d[0] < depth)), d[0], depth)
        Image.fromarray((depth * 10000).astype(np.uint16)).save(scene / "depth" / f"{fid:06d}.png")
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(scene / "rgb" / f"{fid:06d}.png")
        cams[str(fid)] = {"cam_K": K.ravel().tolist(), "depth_scale": 0.1}
        gts[str(fid)] = [{"obj_id": obj, "cam_R_m2c": r.ravel().tolist(), "cam_t_m2c": (t * 1000).tolist()}
                         for obj, (r, t) in poses.items()]
        infos[str(fid)] = [{"visib_fract": float(((depth > 0) & masks[obj]).sum()) / max(masks[obj].sum(), 1)}
                           for obj in poses]
        r1, t1 = poses[1]
        off = Rotation.from_euler("y", 5, degrees=True).as_matrix()
        for i, (name, r, t) in enumerate([("meshaaa", r1, t1), ("meshaaa", off @ r1, t1),
                                          ("meshbbb", poses[2][0], poses[2][1] + [0.01, 0.0, 0.0])]):
            scale = half[1] if name == "meshaaa" else half[2]
            results.append(PoseResult(1, fid, name, 0.9 - 0.1 * i, r, t, scale=scale, time=0.25))
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    (scene / "scene_gt.json").write_text(json.dumps(gts))
    (scene / "scene_gt_info.json").write_text(json.dumps(infos))
    write_results_csv(results, ws / "est.csv", t_scale=1000.0)
    return ws


def _eval_argv(ws, out):
    return ["--results", str(ws / "est.csv"), "--dataset", str(ws / "bop"), "--models-dir", str(ws / "models"),
            "--inference-mesh-dir", str(ws / "inference"), "--models-info",
            str(ws / "models" / "models_info.json"), "--errors", "cus", "chamfer", "chamfer_proj", "vsd",
            "mssd", "mspd", "--out", str(ws / out)]


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(f"scripts.{module}").main()
    return out.getvalue()


def test_eval_bop_pose_cli_matches_jax(bop_ws, monkeypatch):
    from freepose_tpu_torch.scripts import eval_bop_pose

    _run_jax("eval_bop_pose", _eval_argv(bop_ws, "jax.json"), monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        eval_bop_pose.main(_eval_argv(bop_ws, "torch.json") + ["--device", "cpu"])
    ref = json.loads((bop_ws / "jax.json").read_text())
    ours = json.loads((bop_ws / "torch.json").read_text())
    assert ours == ref
    for key in ("AR_cus", "AR_chamfer", "AR_chamfer_proj", "AR_vsd", "AR_mssd", "AR_mspd", "AR"):
        assert 0.0 < ref[key] <= 1.0, (key, ref)
    assert 0.0 < ref["AR"] < 1.0 and ref["mean_time_s"] == 0.25


def test_eval_bop_pose_refuses_a_malformed_csv(bop_ws, tmp_path):
    from freepose_tpu_torch.scripts import eval_bop_pose

    bad = tmp_path / "bad.csv"
    bad.write_text("scene_id,im_id\n1,0\n")
    argv = _eval_argv(bop_ws, "x.json")
    argv[1] = str(bad)
    with pytest.raises(SystemExit, match="results format check failed"):
        eval_bop_pose.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def video_ws(tmp_path_factory):
    """One 12-frame analytic video (GT poses about a rotating axis) and two
    methods' CSVs: the GT with noise, and a drifting track with a NaN pose
    the loader patches from its neighbour."""
    ws = tmp_path_factory.mktemp("torch_eval_videos")
    rng = np.random.default_rng(3)
    n = 12
    poses = np.tile(np.eye(4), (n, 1, 1))
    for t in range(n):
        poses[t, :3, :3] = Rotation.from_rotvec([0.0, 0.05 * t, 0.02 * t]).as_matrix()
        poses[t, :3, 3] = [0.01 * t, -0.005 * t, 1.1]
    (ws / "gt").mkdir()
    np.save(ws / "gt" / "clip_poses_id0.npy", {"poses": poses, "bboxes": np.zeros((n, 4)), "mesh_id": "m",
                                               "focal_length": 600.0, "sym_axis": None}, allow_pickle=True)
    for name, noise in (("a", 0.01), ("b", 0.08)):
        res = []
        for t in range(n):
            r = Rotation.from_rotvec(rng.normal(size=3) * noise).as_matrix() @ poses[t, :3, :3]
            tt = poses[t, :3, 3] + rng.normal(size=3) * noise * (t if name == "b" else 1)
            if name == "b" and t == 5:
                tt = np.full(3, np.nan)
            res.append(PoseResult(0, t, "m", 1.0, r, tt, scale=0.14))
        write_results_csv(res, ws / f"clip_{name}.csv", t_scale=1.0)
    return ws


def test_eval_videos_cli_matches_jax(video_ws, monkeypatch):
    from freepose_tpu_torch.scripts import eval_videos

    def argv(out):
        return ["--gt-dir", str(video_ws / "gt"), "--results-dir", str(video_ws), "--methods", "A=clip_a.csv",
                "B=clip_b.csv", "--videos", "clip", "--width", "640", "--height", "480", "--out-dir",
                str(video_ws / out)]

    _run_jax("eval_videos", argv("jax"), monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        eval_videos.main(argv("torch"))
    for metric in ("rot", "proj", "depth", "mean"):
        ref = (video_ws / "jax" / f"results_{metric}.csv").read_bytes()
        assert (video_ws / "torch" / f"results_{metric}.csv").read_bytes() == ref, metric
    rot = (video_ws / "jax" / "results_rot.csv").read_text().splitlines()
    assert rot[0] == ",A,B" and rot[1].startswith("clip,")


def _save_palette(path, mask):
    img = Image.fromarray(mask.astype(np.uint8), mode="P")
    img.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255] + [0] * (256 * 3 - 12))
    img.save(path)


@pytest.fixture(scope="module")
def sav_ws(tmp_path_factory):
    """GT and predictions for a DAVIS-layout video (id-coded PNGs) and an
    SA-V-layout video (per-object binary PNGs), predictions shifted and
    eroded against the GT; a third GT video has no prediction."""
    ws = tmp_path_factory.mktemp("torch_sav")
    rng = np.random.default_rng(5)
    for root in ("gt", "pred"):
        (ws / root / "davis").mkdir(parents=True)
    (ws / "gt" / "orphan").mkdir()
    _save_palette(ws / "gt" / "orphan" / "00000.png", np.zeros((8, 8)))
    for t in range(6):
        gt = np.zeros((40, 48), np.uint8)
        gt[5 + t:20 + t, 4:18] = 1
        gt[22:36, 20 + t:40] = 2
        pred = np.roll(gt, rng.integers(0, 3), axis=1)
        pred[rng.random(pred.shape) < 0.03] = 0
        _save_palette(ws / "gt" / "davis" / f"{t:05d}.png", gt)
        _save_palette(ws / "pred" / "davis" / f"{t:05d}.png", pred)
        for oid in (1, 2):
            for root, m in (("gt", gt), ("pred", pred)):
                d = ws / root / "sav" / f"{oid:03d}"
                d.mkdir(parents=True, exist_ok=True)
                Image.fromarray(((m == oid) * 255).astype(np.uint8)).save(d / f"{t:05d}.png")
    return ws


@pytest.mark.parametrize("flags", [[], ["--do_not_skip_first_and_last_frame"]])
def test_sav_evaluator_matches_jax(sav_ws, monkeypatch, flags):
    from freepose_tpu_torch.scripts import sav_evaluator

    def argv(name):
        return ["--gt_root", str(sav_ws / "gt"), "--pred_root", str(sav_ws / "pred"), "--csv",
                str(sav_ws / f"{name}.csv"), *flags]

    ref_out = _run_jax("sav_evaluator", argv("jax"), monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sav_evaluator.main(argv("torch"))
    assert out.getvalue() == ref_out
    assert (sav_ws / "torch.csv").read_text() == (sav_ws / "jax.csv").read_text()
    rows = (sav_ws / "jax.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["video", "davis", "sav", "global"]
    assert "skip orphan" in ref_out
    with pytest.raises(SystemExit, match="missing prediction"):
        sav_evaluator.main(argv("strict") + ["--strict"])


# ------------------------------------------------------------- vos_inference

VOS_FRAMES, VOS_SIZE = 5, 64


@pytest.fixture(scope="module")
def vos_ws(tmp_path_factory):
    from freepose_tpu_torch.models.convert import random_sam2_video_params, save_params
    from freepose_tpu_torch.scripts.common import tiny_sam2_video_config
    from freepose_tpu_torch.scripts.vos_inference import davis_palette, save_ann_png

    ws = tmp_path_factory.mktemp("torch_vos")
    rng = np.random.default_rng(7)
    video = ws / "videos" / "vid1"
    video.mkdir(parents=True)
    pal = davis_palette()
    for sub in ("masks/vid1", "masks_obj/vid1/001", "masks_obj/vid1/002", "gt/vid1"):
        (ws / sub).mkdir(parents=True)
    for t in range(VOS_FRAMES):
        img = (rng.random((VOS_SIZE, VOS_SIZE, 3)) * 70).astype(np.uint8)
        ann = np.zeros((VOS_SIZE, VOS_SIZE), np.uint8)
        ann[8 + t:26 + t, 6:24] = 1
        ann[36:56, 30 + t:54 + t] = 2
        img[ann == 1] = [230, 60, 40]
        img[ann == 2] = [40, 90, 230]
        Image.fromarray(img).save(video / f"{t:05d}.jpg", quality=95)
        save_ann_png(ws / "gt" / "vid1" / f"{t:05d}.png", ann, pal)
        if t == 0:
            save_ann_png(ws / "masks" / "vid1" / f"{t:05d}.png", ann, pal)
            save_ann_png(ws / "masks_obj" / "vid1" / "001" / f"{t:05d}.png", (ann == 1).astype(np.uint8), pal)
        if t == 2:  # object 2 appears in the per-object tree on frame 2
            save_ann_png(ws / "masks_obj" / "vid1" / "002" / f"{t:05d}.png", (ann == 2).astype(np.uint8), pal)
    save_params(random_sam2_video_params(tiny_sam2_video_config(), seed=0), ws / "sam2.npz")
    return ws


def _read_masks(root):
    from freepose_tpu_torch.scripts.vos_inference import load_ann_png

    return {str(p.relative_to(root)): load_ann_png(p)[0] for p in sorted(root.rglob("*.png"))}


@pytest.mark.parametrize("mode", ["palette", "per_object_all_masks"])
def test_vos_inference_cli_matches_jax(vos_ws, monkeypatch, mode):
    from freepose_tpu_torch.scripts import vos_inference

    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    masks, extra = ("masks", []) if mode == "palette" else ("masks_obj", ["--per-obj-png-file", "--use-all-masks"])

    def argv(out):
        return ["--base-video-dir", str(vos_ws / "videos"), "--input-mask-dir", str(vos_ws / masks),
                "--output-mask-dir", str(vos_ws / f"{out}_{mode}"), "--gt-mask-dir", str(vos_ws / "gt"),
                "--sam2-weights", str(vos_ws / "sam2.npz"), *extra]

    ref_lines = _run_jax("vos_inference", argv("jax"), monkeypatch).strip().splitlines()
    with contextlib.redirect_stdout(io.StringIO()):
        reports = vos_inference.main(argv("torch") + ["--device", "cpu"])
    ref_report, ref_mean = json.loads(ref_lines[0]), json.loads(ref_lines[1])
    (report,) = reports
    assert report["frames"] == ref_report["frames"] == VOS_FRAMES
    assert report["objects"] == ref_report["objects"] == [1, 2]
    assert abs(report["J&F"] - ref_report["J&F"]) <= 1e-2 and abs(report["J&F"] - ref_mean["mean J&F"]) <= 1e-2
    for oid, scores in ref_report["per_object"].items():
        assert abs(report["per_object"][int(oid)]["J&F"] - scores["J&F"]) <= 1e-2
    ref, ours = _read_masks(vos_ws / f"jax_{mode}"), _read_masks(vos_ws / f"torch_{mode}")
    assert sorted(ours) == sorted(ref) and len(ref) == VOS_FRAMES * (1 if mode == "palette" else 2)
    for name, m in ref.items():
        assert int((ours[name] != m).sum()) <= MASK_PX, name
    if mode == "per_object_all_masks":  # object 2 is tracked from its first mask, on frame 2
        for t in range(VOS_FRAMES):
            assert (ref[f"vid1/002/{t:05d}.png"].any()) == (t >= 2)
