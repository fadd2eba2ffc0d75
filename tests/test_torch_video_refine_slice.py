"""The video fine-refine slice through both packages' CLIs, on the CPU.

dino_inference_video, JAX CLI and port CLI in-process, on one tiny
workspace: a coloured blob mesh, 5 rendered 240x320 frames of a slow
rotation with one tracked proposal each (with its scale), 8-view 84²
template shards written by the port's render_templates, one .npz of the JAX
VIT_TEST DINOv2 weights, FREEPOSE_TINY_MODELS=1, --layer 2, --n-coarse 8,
--n-fine 64, --n-neighbors 16, --neighborhood 40. Both run fp32 with plain
attention and the plain rasterizer.

The CSVs agree row for row (frame, object). R agrees to 1e-6 (the port's
super-Fibonacci grid is the JAX one to float32 rounding) wherever the JAX
neighbourhood's top-2 score margin exceeds 1e-4; t and scores within 1e-4
(fp32 ViT sums in another order). Within the port, --chain-refine 0 gives
the rows of --chain-refine 1.
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from freepose_tpu_torch.datasets.video import AsyncVideoFrameLoader, load_frame_dir
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.geometry.camera import default_video_intrinsics
from freepose_tpu_torch.io.bop_csv import read_results_csv
from freepose_tpu_torch.io.mesh import TriMesh, pad_mesh, save_obj
from freepose_tpu_torch.io.proposals_json import proposal_entry, save_proposals
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize

N_FRAMES, H, W = 5, 240, 320
MESH = "blobmesh"
R_ATOL, T_ATOL, MARGIN = 1e-6, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the suite runs several files
    at once, one per worker, and torch's default of one thread per core in
    each worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _blob(seed=0):
    rng = np.random.default_rng(seed)
    n_lat, n_lon = 10, 14
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 1.0 + 0.2 * np.sin(3 * ph) * np.sin(2 * th)
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                   rng.random((len(verts), 3)).astype(np.float32))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from freepose_tpu_torch.scripts import render_templates
    from scripts.common import save_params

    ws = tmp_path_factory.mktemp("torch_video_refine")
    mesh = _blob()
    (ws / "meshes" / MESH).mkdir(parents=True)
    save_obj(mesh, ws / "meshes" / MESH / f"{MESH}.obj")
    (ws / "filelist.txt").write_text(f"{MESH}\n")

    k = default_video_intrinsics(W, H)
    scale = 0.12
    gt = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
    for t in range(N_FRAMES):
        gt[t, :3, :3] = Rotation.from_rotvec([0, 0.06 * t, 0.02 * t]).as_matrix()
        gt[t, :3, 3] = [0.02 * t - 0.02, 0.0, 1.2]
    v, c, f, valid = (torch.as_tensor(a) for a in pad_mesh(mesh.scaled(scale), 512, 1024))
    rgb, depth = rasterize(v, c, f, valid, torch.as_tensor(gt), k, RasterSettings(resolution=320, tile=32))
    (ws / "frames").mkdir()
    props = []
    for t in range(N_FRAMES):
        Image.fromarray((rgb[t, :H, :W].numpy() * 255).astype(np.uint8)).save(ws / "frames" / f"{t:06d}.png")
        mask = depth[t, :H, :W].numpy() > 0
        entry = proposal_entry(mask_to_bbox(torch.as_tensor(mask)).numpy(), mask, MESH, 0.9, 0, t, scale=scale)
        entry["track_id"] = 0
        props.append(entry)
    save_proposals(props, ws / "props.json")

    render_templates.main(["--mesh-dir", str(ws / "meshes"), "--filelist", str(ws / "filelist.txt"),
                           "--out", str(ws / "shards"), "--n-poses", "8", "--resolution", "84",
                           "--device", "cpu"])
    params = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(1)
    for name in ("ls1", "ls2"):  # LayerScale well away from its 1e-5 init
        g = params["blocks"]["block"][name]["gamma"]
        params["blocks"]["block"][name]["gamma"] = rng.uniform(0.2, 0.6, g.shape).astype(np.float32)
    save_params(params, ws / "dinov2.npz")
    return ws


def _argv(ws, out, *extra):
    return ["--video-dir", str(ws / "frames"), "--proposals", str(ws / "props.json"),
            "--wds-dir", str(ws / "shards"), "--filelist", str(ws / "filelist.txt"),
            "--mesh-dir", str(ws / "meshes"), "--out", str(out), "--weights", str(ws / "dinov2.npz"),
            "--layer", "2", "--n-coarse", "8", "--n-fine", "64", "--n-neighbors", "16",
            "--neighborhood", "40", *extra]


@pytest.fixture
def tiny_env(monkeypatch):
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.setenv("FREEPOSE_TEMPLATE_VIEWS", "8")
    return monkeypatch


def _run_jax(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dino_inference_video", *argv])
    importlib.import_module("scripts.dino_inference_video").main()


def _run_port(argv):
    from freepose_tpu_torch.scripts import dino_inference_video

    dino_inference_video.main([*argv, "--device", "cpu"])


def _jax_top2_margin(ws, frame: int, prev_r: np.ndarray, zoom: bool) -> float:
    """The JAX package's top-2 score margin over the neighbourhood of
    prev_r on `frame` (its uncached refine of the same crop)."""
    from freepose_tpu.datasets.video import load_frame_dir as jax_load
    from freepose_tpu.io.proposals_json import load_proposals, proposal_bbox_xyxy, proposal_mask
    from freepose_tpu.models.dinov2 import DinoFeatureExtractor
    from freepose_tpu.pipeline import online_pose_estimator as ope
    from freepose_tpu.pipeline.proposals import extract_proposals
    from freepose_tpu.pipeline.renderer import TemplateRenderer
    from scripts.common import load_params

    p = [q for q in load_proposals(ws / "props.json") if q["image_id"] == frame][0]
    props = extract_proposals(jnp.asarray(jax_load(ws / "frames")[frame]), jnp.asarray(proposal_mask(p))[None],
                              jnp.asarray(proposal_bbox_xyxy(p), jnp.float32)[None], target_size=420,
                              bbox_extend=0.2)
    ext = DinoFeatureExtractor(JAX_VIT_TEST, params=load_params(str(ws / "dinov2.npz")))
    renderer = TemplateRenderer(n_poses=8)
    from freepose_tpu.geometry.rotation import template_poses
    from freepose_tpu.io.mesh import load_obj

    mesh = load_obj(ws / "meshes" / MESH / f"{MESH}.obj").normalized()
    prev = np.eye(4, dtype=np.float32)
    prev[:3, :3] = prev_r
    v, c, f, fv = renderer._padded(mesh, 0.25)
    _, _, valid, feats, masks, _ = ope._refine_prepare_fused(
        template_poses(64), jnp.asarray(prev), jnp.float32(40.0), v, c, f, fv, renderer.k,
        ext.params_for(2), renderer.settings, 16, renderer.pose_chunk, 420, ext, 2, zoom)
    qf = ext(props.proposals, layer=2, feature_type="patch")[0]
    qf = qf / jnp.linalg.norm(qf, axis=-1, keepdims=True)
    scores = np.sort(np.asarray(ope.rescore_views(feats, qf, valid, masks, props.masks[0], 30, False)))
    return float(scores[-1] - scores[-2])


def _assert_rows_match(ours, ref, ws, zoom=False):
    assert [(r.im_id, str(r.obj_id)) for r in ours] == [(r.im_id, str(r.obj_id)) for r in ref]
    assert len(ours) == N_FRAMES
    for o, r in zip(ours, ref):
        assert np.isfinite(o.t).all() and o.t[2] > 0
        np.testing.assert_allclose(o.R @ o.R.T, np.eye(3), atol=1e-5)
        if not np.allclose(o.R, r.R, atol=R_ATOL):
            prev = [q for q in ref if q.im_id == r.im_id - 1][0]
            margin = _jax_top2_margin(ws, r.im_id, prev.R, zoom)
            assert margin <= MARGIN, f"frame {r.im_id}: R differs with a top-2 margin of {margin}"
            continue
        np.testing.assert_allclose(o.t, r.t, atol=T_ATOL)
        np.testing.assert_allclose(o.score, r.score, atol=T_ATOL)


@pytest.mark.parametrize("extra", [[], ["--zoom-renders"]], ids=["default", "zoom"])
def test_cli_matches_jax(workspace, tiny_env, extra):
    ws = workspace
    _run_jax(_argv(ws, ws / f"jax{len(extra)}.csv", *extra), tiny_env)
    _run_port(_argv(ws, ws / f"torch{len(extra)}.csv", *extra))
    ref = read_results_csv(ws / f"jax{len(extra)}.csv", t_scale=1.0)
    ours = read_results_csv(ws / f"torch{len(extra)}.csv", t_scale=1.0)
    _assert_rows_match(ours, ref, ws, zoom=bool(extra))


def test_chain_equals_serial_in_the_port(workspace, tiny_env):
    ws = workspace
    _run_port(_argv(ws, ws / "chain.csv"))
    _run_port(_argv(ws, ws / "serial.csv", "--chain-refine", "0"))
    chain = read_results_csv(ws / "chain.csv", t_scale=1.0)
    serial = read_results_csv(ws / "serial.csv", t_scale=1.0)
    assert [(r.im_id, str(r.obj_id)) for r in serial] == [(r.im_id, str(r.obj_id)) for r in chain]
    for a, b in zip(serial, chain):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_allclose(a.t, b.t, atol=1e-5)
        np.testing.assert_allclose(a.score, b.score, atol=1e-5)


def test_no_rescore_scores_match_jax(workspace, tiny_env):
    ws = workspace
    (ws / "nore_jax").mkdir()
    (ws / "nore_torch").mkdir()
    _run_jax(_argv(ws, ws / "nore_jax" / "vid.csv", "--no-rescore"), tiny_env)
    _run_port(_argv(ws, ws / "nore_torch" / "vid.csv", "--no-rescore"))
    ours, ref = (np.load(ws / d / "all_scores.npy") for d in ("nore_torch", "nore_jax"))
    assert ours.shape == ref.shape == (1, N_FRAMES, 8)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    ours, ref = (np.load(ws / d / "all_poses.npy") for d in ("nore_torch", "nore_jax"))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    assert len(read_results_csv(ws / "nore_torch" / "vid.csv", t_scale=1.0)) == N_FRAMES


def test_cli_refuses_what_is_not_ported(workspace, tiny_env):
    """--shard-refine: the JAX CLI fans the cached refine's miss batches
    over its 8 CPU devices, the port's over a one-device CPU mesh (it adds
    no shard count); the rows agree as the unsharded CLIs' do, and the
    port's equal its serial cached rows (the flag turns the chain off)."""
    ws = workspace
    _run_jax(_argv(ws, ws / "jax_shard.csv", "--shard-refine"), tiny_env)
    _run_port(_argv(ws, ws / "torch_shard.csv", "--shard-refine"))
    ours = read_results_csv(ws / "torch_shard.csv", t_scale=1.0)
    _assert_rows_match(ours, read_results_csv(ws / "jax_shard.csv", t_scale=1.0), ws)
    _run_port(_argv(ws, ws / "serial_ref.csv", "--chain-refine", "0"))
    serial = read_results_csv(ws / "serial_ref.csv", t_scale=1.0)
    for a, b in zip(ours, serial):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_allclose(a.t, b.t, atol=1e-5)
        np.testing.assert_allclose(a.score, b.score, atol=1e-5)


def test_async_loader_matches_load_frame_dir(workspace):
    eager = load_frame_dir(workspace / "frames")
    loader = AsyncVideoFrameLoader(workspace / "frames")
    assert loader.shape == eager.shape and len(loader) == N_FRAMES
    for t in range(N_FRAMES):
        np.testing.assert_array_equal(loader[t], eager[t])
    loader.join()
    assert not loader._thread.is_alive() and loader.exception is None
