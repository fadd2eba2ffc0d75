"""End-to-end known-GT accuracy of the PyTorch port, on the CPU.

The port's twin of tests/test_e2e_accuracy.py: the same per-vertex-colour
blob mesh rendered (by the port's rasterizer) along the same analytic SE(3)
trajectory, GT-mask proposals, then the port's CLIs render_templates ->
dino_inference_video -> smooth_poses_video -> eval_videos, in-process with
--device cpu, FREEPOSE_TINY_MODELS=1 (the tiny random-init DINOv2: the query
frames are renders of the same mesh, so matching is meaningful without
released weights) and 8 coarse views. The tracks must stay within the same
rotation, projection and depth drift thresholds as the JAX test, which a
stopped tracker (random relative rotations drift ~90 deg) breaks by an
order of magnitude; with the ZNCC tracker and with CoTracker2 on the JAX
test's crafted correlation-argmax weights.
"""
import contextlib
import io

import numpy as np
import pytest
import torch
from PIL import Image

pytestmark = pytest.mark.slow

N_FRAMES = 16
H, W = 240, 320
SCALE = 0.12
DEG_PER_FRAME = 2.0
N_COARSE = 8
N_FINE = 2000
CPU = ["--device", "cpu"]


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv)


def _axis_angle(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.radians(deg)
    kx, ky, kz = axis
    km = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return (np.eye(3) + np.sin(a) * km + (1 - np.cos(a)) * km @ km).astype(np.float32)


@pytest.fixture(scope="module")
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FREEPOSE_TINY_MODELS", "1")
        mp.setenv("FREEPOSE_TEMPLATE_VIEWS", str(N_COARSE))
        yield


@pytest.fixture(scope="module")
def gt_ws(tmp_path_factory, env):
    """16-frame synthetic video along an analytic trajectory: mesh, frames,
    GT-mask proposals, template shards and the GT .npy."""
    from freepose_tpu_torch.geometry.boxes import mask_to_bbox
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.geometry.rotation import template_poses
    from freepose_tpu_torch.io.mesh import TriMesh, pad_mesh, save_obj
    from freepose_tpu_torch.io.proposals_json import proposal_entry, save_proposals
    from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize
    from freepose_tpu_torch.scripts import render_templates

    ws = tmp_path_factory.mktemp("torch_gt_video")
    rng = np.random.default_rng(7)
    n_lat, n_lon = 12, 16
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 1.0 + 0.25 * np.sin(3 * ph) * np.sin(2 * th)
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    mesh = TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                   rng.random((len(verts), 3)).astype(np.float32))
    mesh_dir = ws / "meshes" / "blobmesh"
    mesh_dir.mkdir(parents=True)
    save_obj(mesh, mesh_dir / "blobmesh.obj")
    (ws / "filelist.txt").write_text("blobmesh\n")

    # Frame 0's rotation sits on a coarse template view, then 2 deg/frame
    # about a wobbling axis with a slow lateral drift at constant depth.
    k = default_video_intrinsics(W, H, device="cpu").numpy()
    r0 = template_poses(N_COARSE, device="cpu")[3, :3, :3].numpy()
    gt = []
    for t in range(N_FRAMES):
        p = np.eye(4, dtype=np.float32)
        r = r0.copy()
        for _ in range(t):
            r = _axis_angle([0.2, 1.0, 0.3], DEG_PER_FRAME) @ r
        p[:3, :3] = r
        p[:3, 3] = [0.015 * t - 0.1, 0.008 * t, 1.2]
        gt.append(p)
    gt = np.stack(gt)

    v, c, f, valid = (torch.as_tensor(a) for a in pad_mesh(mesh.scaled(SCALE), 512, 1024))
    rgb, depth = rasterize(v, c, f, valid, torch.as_tensor(gt), torch.as_tensor(k),
                           RasterSettings(resolution=320, tile=32, max_faces_per_tile=256))
    (ws / "frames").mkdir()
    props = []
    for t in range(N_FRAMES):
        mask = depth[t, :H, :W] > 0
        Image.fromarray((rgb[t, :H, :W].numpy() * 255).astype(np.uint8)).save(ws / "frames" / f"{t:06d}.png")
        entry = proposal_entry(mask_to_bbox(mask).numpy(), mask.numpy(), "blobmesh", 0.9, 0, t, scale=SCALE)
        entry["track_id"] = 0
        props.append(entry)
    save_proposals(props, ws / "props.json")
    _quiet(render_templates.main, ["--mesh-dir", str(ws / "meshes"), "--filelist", str(ws / "filelist.txt"),
                                   "--out", str(ws / "shards"), "--n-poses", str(N_COARSE), "--resolution", "84",
                                   *CPU])
    (ws / "gt").mkdir()
    np.save(ws / "gt" / "vid_poses_id0.npy", {"poses": gt, "bboxes": np.zeros((N_FRAMES, 4)), "mesh_id": "blobmesh",
                                             "focal_length": float(k[0, 0])}, allow_pickle=True)
    return ws, gt, k


@pytest.fixture(scope="module")
def fine_csv(gt_ws):
    from freepose_tpu_torch.scripts import dino_inference_video

    ws, _, _ = gt_ws
    _quiet(dino_inference_video.main, [
        "--video-dir", str(ws / "frames"), "--proposals", str(ws / "props.json"), "--wds-dir", str(ws / "shards"),
        "--filelist", str(ws / "filelist.txt"), "--mesh-dir", str(ws / "meshes"), "--out", str(ws / "vid.csv"),
        "--layer", "2", "--n-coarse", str(N_COARSE), "--n-fine", str(N_FINE), "--n-neighbors", "64",
        "--neighborhood", "40", *CPU])
    return ws / "vid.csv"


def _geodesic_deg(ra, rb):
    return np.degrees(np.arccos(np.clip((np.trace(ra.T @ rb) - 1) / 2, -1, 1)))


def _rel_rot_err(track, gt):
    return np.array([_geodesic_deg(track[t + 1].R @ track[t].R.T, gt[t + 1, :3, :3] @ gt[t, :3, :3].T)
                     for t in range(N_FRAMES - 1)])


def _read(path):
    from freepose_tpu_torch.io.bop_csv import read_results_csv

    rows = read_results_csv(path, t_scale=1.0)
    rows.sort(key=lambda r: r.im_id)
    return rows


def test_full_chain_tracks_known_gt(gt_ws, fine_csv):
    """proposals -> dino_inference_video -> smooth_poses_video -> eval_videos
    must track the analytic trajectory, under the JAX test's gates."""
    import pandas as pd

    from freepose_tpu_torch.scripts import eval_videos, smooth_poses_video

    ws, gt, k = gt_ws
    _quiet(smooth_poses_video.main, ["--video-dir", str(ws / "frames"), "--poses", str(fine_csv), "--mesh-dir",
                                     str(ws / "meshes"), "--out", str(ws / "vid-tracked.csv"), "--interval", "4",
                                     *CPU])
    fine, tracked = _read(fine_csv), _read(ws / "vid-tracked.csv")
    assert len(fine) == len(tracked) == N_FRAMES
    drel_fine, drel_trk = _rel_rot_err(fine, gt), _rel_rot_err(tracked, gt)
    z_fine = np.array([fine[t].t[2] for t in range(N_FRAMES)])

    def centre_px(t):
        uvw = k @ t
        return uvw[:2] / uvw[2]

    proj_err = np.array([np.linalg.norm(centre_px(fine[t].t) - centre_px(gt[t, :3, 3])) for t in range(N_FRAMES)])
    proj_err = proj_err / float(np.hypot(W, H)) * 100
    assert np.abs(z_fine - 1.2).mean() < 0.2, z_fine
    assert proj_err.mean() < 3.0, proj_err

    _quiet(eval_videos.main, ["--gt-dir", str(ws / "gt"), "--results-dir", str(ws), "--methods", "fine={video}.csv",
                              "tracked={video}-tracked.csv", "--width", str(W), "--height", str(H), "--out-dir",
                              str(ws / "tables")])
    rot = pd.read_csv(ws / "tables" / "results_rot.csv", index_col=0)
    proj = pd.read_csv(ws / "tables" / "results_proj.csv", index_col=0)
    depth = pd.read_csv(ws / "tables" / "results_depth.csv", index_col=0)
    for m in ("fine", "tracked"):
        assert float(rot[m].iloc[0]) < 20.0, rot  # deg drift per gap
        assert float(proj[m].iloc[0]) < 6.0, proj  # % of the diagonal
        assert float(depth[m].iloc[0]) < 0.25, depth  # scale-normalised
    assert drel_fine.mean() < 10.0, drel_fine
    assert drel_trk.mean() < 10.0, drel_trk


def test_full_chain_tracks_known_gt_cotracker2(gt_ws, fine_csv):
    """`--tracker cotracker2` through the port's smooth_poses_video, on the
    JAX test's crafted correlation-argmax weights (tests/test_cotracker2.py:
    the no-checkpoint tracking oracle), under the same co-rotation gate."""
    import dataclasses
    import json

    from freepose_tpu.models import convert
    from freepose_tpu.models.cotracker2 import COTRACKER2_TEST
    from freepose_tpu_torch.models.convert import save_params
    from freepose_tpu_torch.scripts import smooth_poses_video
    from tests.test_cotracker2 import TCoTracker2, _craft_corr_argmax

    ws, gt, _ = gt_ws
    cfg = dataclasses.replace(COTRACKER2_TEST, corr_radius=2, hidden_size=128, model_resolution=(H, W))
    torch.manual_seed(0)
    full = TCoTracker2(cfg).eval()
    _craft_corr_argmax(full, cfg)
    sd = {key: v.detach().numpy() for key, v in full.state_dict().items()}
    save_params(convert.cotracker2_from_hub(sd, depth=cfg.depth), ws / "ct2.npz")
    (ws / "ct2.json").write_text(json.dumps({
        "latent_dim": cfg.latent_dim, "corr_levels": cfg.corr_levels, "corr_radius": cfg.corr_radius,
        "flow_emb_dim": cfg.flow_emb_dim, "hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
        "depth": cfg.depth, "num_virtual_tracks": cfg.num_virtual_tracks, "model_resolution": [H, W],
        "iters": cfg.iters, "precision": "highest"}))
    _quiet(smooth_poses_video.main, ["--video-dir", str(ws / "frames"), "--poses", str(fine_csv), "--mesh-dir",
                                     str(ws / "meshes"), "--out", str(ws / "vid-ct2.csv"), "--interval", "4",
                                     "--tracker", "cotracker2", "--tracker-weights", str(ws / "ct2.npz"),
                                     "--tracker-config", str(ws / "ct2.json"), *CPU])
    tracked = _read(ws / "vid-ct2.csv")
    assert len(tracked) == N_FRAMES
    drel = _rel_rot_err(tracked, gt)
    assert drel.mean() < 10.0, drel
    assert np.isfinite(np.stack([r.t for r in tracked])).all()
