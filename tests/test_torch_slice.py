"""The static coarse-pose slice through both packages, and the port's rules.

Slice: a tiny coloured mesh, 8 template views at 56², the JAX model's own
VIT_TEST parameters (fp32) in both packages. TemplateBank.build_pack and
CoarsePoseEstimator.estimate_batch agree (feats atol 1e-4: fp32 ViT sums in
another order; pointcloud stats atol 1e-5; lifted poses atol 1e-4; view
indices identical). Then the port's render_templates + dino_inference CLIs
against the JAX CLIs, in-process, with one .npz of weights and
FREEPOSE_TINY_MODELS=1: the shards decode to the same hit masks, with depth
within one millimetre step and rgb within one 8-bit step (the renders agree
to 1e-5 before quantisation), and the BOP CSV rows agree (same scene, image and
object; R atol 1e-4; t atol 1e-2 mm).

Rules: importing every module of freepose_tpu_torch loads neither JAX nor
the JAX package; an entry point asked for no device, on a machine without a
GPU, raises instead of running on the host.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freepose_tpu.geometry.boxes import mask_to_bbox as jax_mask_to_bbox
from freepose_tpu.geometry.rotation import template_poses as jax_template_poses
from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
from freepose_tpu.models.dinov2 import DinoFeatureExtractor as JaxExtractor
from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from freepose_tpu.pipeline.pose_estimator import CoarsePoseEstimator as JaxEstimator
from freepose_tpu.pipeline.proposals import extract_proposals as jax_extract_proposals
from freepose_tpu.pipeline.renderer import TemplateRenderer as JaxRenderer
from freepose_tpu.pipeline.template_bank import TemplateBank as JaxBank
from freepose_tpu_torch.datasets.template import WebTemplateDataset
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.io.bop_csv import read_results_csv
from freepose_tpu_torch.io.mesh import TriMesh, save_obj
from freepose_tpu_torch.io.proposals_json import proposal_entry, save_proposals
from freepose_tpu_torch.models.dinov2 import VIT_TEST, DinoFeatureExtractor
from freepose_tpu_torch.pipeline.pose_estimator import CoarsePoseEstimator
from freepose_tpu_torch.pipeline.proposals import extract_proposals
from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
from freepose_tpu_torch.pipeline.template_bank import TemplateBank, TemplatePack

REPO = Path(__file__).resolve().parent.parent
N_VIEWS, RES, LAYER = 8, 56, 2


def _mesh(seed=0, n_lat=8, n_lon=12):
    rng = np.random.default_rng(seed)
    bump = rng.uniform(0.1, 0.3)
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 1.0 + bump * np.sin(2 * ph) * np.sin(th)
            verts.append([r * np.sin(th) * np.cos(ph), 0.7 * r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    v = np.asarray(verts, np.float32)
    return TriMesh(v, np.asarray(faces, np.int32), rng.random((len(v), 3)).astype(np.float32)).normalized()


@pytest.fixture(scope="module")
def params():
    """The JAX model's VIT_TEST parameters with non-trivial LayerScale."""
    p = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    p = jax.tree_util.tree_map(np.array, p)
    rng = np.random.default_rng(1)
    for name in ("ls1", "ls2"):
        g = p["blocks"]["block"][name]["gamma"]
        p["blocks"]["block"][name]["gamma"] = rng.uniform(0.2, 0.6, g.shape).astype(np.float32)
    return p


def _frame_poses():
    """Two query poses off the template grid, object at z = 0.9 / 1.3 m."""
    rng = np.random.default_rng(2)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    for i, (q, z) in enumerate(zip(rng.normal(size=(2, 4)), (0.9, 1.3))):
        q = q / np.linalg.norm(q)
        x, y, zz, w = q
        poses[i, :3, :3] = [[1 - 2 * (y * y + zz * zz), 2 * (x * y - w * zz), 2 * (x * zz + w * y)],
                            [2 * (x * y + w * zz), 1 - 2 * (x * x + zz * zz), 2 * (y * zz - w * x)],
                            [2 * (x * zz - w * y), 2 * (y * zz + w * x), 1 - 2 * (x * x + y * y)]]
        poses[i, :3, 3] = [0.02, -0.01, z]
    return poses


def test_build_pack_and_estimate_batch_match_jax(params):
    mesh = _mesh()
    poses = _frame_poses()
    scales = np.array([0.25, 0.3], np.float32)

    jext = JaxExtractor(JAX_VIT_TEST, params=params)
    jfn = lambda imgs: jext(imgs, layer=LAYER, feature_type="patch")  # noqa: E731
    jbank = JaxBank(jfn, renderer=JaxRenderer(n_poses=N_VIEWS, resolution=RES), batch_size=4)
    jpack = jbank.build_pack("m", mesh)
    jrgb, jdepth = jbank.renderer.render_from_poses(mesh, jnp.asarray(poses))
    jprops = [jax_extract_proposals(jrgb[i], (jdepth[i] > 0)[None], jax_mask_to_bbox(jdepth[i] > 0)[None],
                                    target_size=RES) for i in range(2)]
    jout = JaxEstimator(jfn, jbank, n_poses=N_VIEWS).estimate_batch(
        jnp.concatenate([p.proposals for p in jprops]), [jpack, jpack], jbank.k,
        np.concatenate([np.asarray(p.boxes) for p in jprops]), scales)

    ext = DinoFeatureExtractor(VIT_TEST, params=params, device="cpu")
    fn = lambda imgs: ext(imgs, layer=LAYER, feature_type="patch")  # noqa: E731
    bank = TemplateBank(fn, renderer=TemplateRenderer(n_poses=N_VIEWS, resolution=RES, device="cpu"),
                        batch_size=4)
    pack = bank.build_pack("m", mesh)
    rgb, depth = bank.renderer.render_from_poses(mesh, torch.as_tensor(poses))
    np.testing.assert_array_equal(depth.numpy() > 0, np.asarray(jdepth) > 0)
    props = [extract_proposals(rgb[i], (depth[i] > 0)[None], mask_to_bbox(depth[i] > 0)[None], target_size=RES)
             for i in range(2)]
    out = CoarsePoseEstimator(fn, bank, n_poses=N_VIEWS).estimate_batch(
        torch.cat([p.proposals for p in props]), [pack, pack], bank.k,
        torch.cat([p.boxes for p in props]), scales)

    np.testing.assert_allclose(pack.feats.numpy(), np.asarray(jpack.feats), atol=1e-4)
    for name in ("pc_min", "pc_max", "pc_mean"):
        np.testing.assert_allclose(getattr(pack, name).numpy(), np.asarray(getattr(jpack, name)), atol=1e-5)
    np.testing.assert_allclose(pack.poses.numpy(), np.asarray(jpack.poses), atol=1e-6)
    assert len(out) == len(jout) == 2
    for o, j in zip(out, jout):
        np.testing.assert_array_equal(o.view_indices.numpy(), np.asarray(j.view_indices))
        np.testing.assert_allclose(o.scores.numpy(), np.asarray(j.scores), atol=1e-5)
        np.testing.assert_allclose(o.tcos.numpy(), np.asarray(j.tcos), atol=1e-4)


def test_pack_disk_tier_is_read_by_both_packages(tmp_path):
    """The .npz pack cache: same keys, fp16 feats; each package reads the
    other's files, and a corrupt file is rebuilt rather than read."""
    from freepose_tpu.pipeline.template_bank import TemplatePack as JaxPack

    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(3, 4, 8)).astype(np.float32)] + [
        rng.normal(size=(3, 3)).astype(np.float32) for _ in range(3)] + [np.array(jax_template_poses(3))]
    bank = TemplateBank(None, renderer=TemplateRenderer(n_poses=3, resolution=RES, device="cpu"),
                        cache_dir=tmp_path)
    jbank = JaxBank(None, renderer=JaxRenderer(n_poses=3, resolution=RES), cache_dir=tmp_path)
    bank._save_disk(TemplatePack("ours", *map(torch.as_tensor, arrays)))
    jbank._save_disk(JaxPack("theirs", *map(jnp.asarray, arrays)))
    for ours, theirs in ((bank.get("ours"), jbank.get("ours")), (bank.get("theirs"), jbank.get("theirs"))):
        for name, ref in zip(("feats", "pc_min", "pc_max", "pc_mean", "poses"), arrays):
            if name == "feats":
                ref = ref.astype(np.float16).astype(np.float32)
            np.testing.assert_array_equal(getattr(ours, name).numpy(), ref)
            np.testing.assert_array_equal(np.asarray(getattr(theirs, name)), ref)
    (tmp_path / "broken.npz").write_bytes((tmp_path / "ours.npz").read_bytes()[:100])
    assert bank._load_disk("broken") is None
    with pytest.raises(KeyError):
        bank.get("broken")  # not loadable and no mesh to rebuild from


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, params):
    """Two meshes, a one-frame BOP scene, a GT-mask proposal JSON with a
    scale, and one .npz of JAX-layout VIT_TEST weights."""
    from scripts.common import save_params

    ws = tmp_path_factory.mktemp("torch_slice")
    for seed, name in enumerate(("meshaaa", "meshbbb")):
        (ws / "meshes" / name).mkdir(parents=True)
        save_obj(_mesh(seed), ws / "meshes" / name / f"{name}.obj")
    (ws / "filelist.txt").write_text("meshaaa\nmeshbbb\n")

    rng = np.random.default_rng(0)
    scene = ws / "bop" / "test" / "000001"
    (scene / "rgb").mkdir(parents=True)
    (scene / "depth").mkdir()
    img = (rng.random((120, 160, 3)) * 255).astype(np.uint8)
    img[30:80, 50:110] = [200, 60, 60]
    Image.fromarray(img).save(scene / "rgb" / "000000.png")
    Image.fromarray(np.zeros((120, 160), np.uint16)).save(scene / "depth" / "000000.png")
    (scene / "scene_camera.json").write_text(json.dumps(
        {"0": {"cam_K": [150.0, 0, 80, 0, 150, 60, 0, 0, 1], "depth_scale": 0.1}}))
    mask = np.zeros((120, 160), bool)
    mask[30:80, 50:110] = True
    save_proposals([proposal_entry(np.array([50, 30, 110, 80]), mask, "meshaaa", 0.9, 1, 0, scale=0.1)],
                   ws / "props.json")
    save_params(params, ws / "dinov2.npz")
    return ws


def _run_jax_cli(module: str, argv: list[str], monkeypatch) -> None:
    import importlib

    monkeypatch.setattr(sys, "argv", [module, *argv])
    importlib.import_module(module).main()


def test_clis_match_jax(workspace, monkeypatch):
    from freepose_tpu_torch.scripts import dino_inference, render_templates

    ws = workspace
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.setenv("FREEPOSE_TEMPLATE_VIEWS", str(N_VIEWS))
    render = ["--mesh-dir", str(ws / "meshes"), "--filelist", str(ws / "filelist.txt"),
              "--n-poses", str(N_VIEWS), "--resolution", str(RES)]

    def infer(shards, out):
        return ["--dataset", str(ws / "bop"), "--split", "test", "--proposals", str(ws / "props.json"),
                "--wds-dir", str(shards), "--filelist", str(ws / "filelist.txt"), "--out", str(out),
                "--layer", str(LAYER), "--depth-method", "zoedepth", "--weights", str(ws / "dinov2.npz")]

    _run_jax_cli("scripts.render_templates", render + ["--out", str(ws / "shards_jax")], monkeypatch)
    _run_jax_cli("scripts.dino_inference", infer(ws / "shards_jax", ws / "poses_jax.csv"), monkeypatch)
    render_templates.main(render + ["--out", str(ws / "shards_torch"), "--device", "cpu"])
    dino_inference.main(infer(ws / "shards_torch", ws / "poses_torch.csv") + ["--device", "cpu"])

    names = ["meshaaa", "meshbbb"]
    for name in names:
        ours = WebTemplateDataset(ws / "shards_torch", names).get_template_by_name(name)
        ref = WebTemplateDataset(ws / "shards_jax", names).get_template_by_name(name)
        np.testing.assert_array_equal(ours["depth"] > 0, ref["depth"] > 0)
        np.testing.assert_allclose(ours["depth"], ref["depth"], atol=1.01e-3)
        np.testing.assert_allclose(ours["rgb"], ref["rgb"], atol=1.01 / 255)

    ours = read_results_csv(ws / "poses_torch.csv", t_scale=1000.0)
    ref = read_results_csv(ws / "poses_jax.csv", t_scale=1000.0)
    assert len(ours) == len(ref) == 1
    for o, r in zip(ours, ref):
        assert (o.scene_id, o.im_id, o.obj_id) == (r.scene_id, r.im_id, r.obj_id) == (1, 0, "meshaaa")
        np.testing.assert_allclose(o.R, r.R, atol=1e-4)
        np.testing.assert_allclose(o.t * 1000.0, r.t * 1000.0, atol=1e-2)
        assert o.time > 0


def test_dino_inference_depthmap_matches_jax(workspace, monkeypatch, tmp_path):
    """--depth-method depthmap: each proposal's scale is its mask's
    pointcloud half-extent in the dataset's depth (pipeline/
    scale_estimator.depth_scales). The scene's depth is a seeded bumpy
    plane at ~1.2 m; both CLIs read one set of template shards. The CSV
    rows agree as in test_clis_match_jax, and the scale column to rtol 1e-5
    (fp32 extents of the same pointcloud)."""
    import shutil

    from freepose_tpu_torch.scripts import dino_inference, render_templates

    ws = workspace
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.setenv("FREEPOSE_TEMPLATE_VIEWS", str(N_VIEWS))
    bop = tmp_path / "bop"
    shutil.copytree(ws / "bop", bop, ignore=shutil.ignore_patterns("*_metadata.json"))
    rng = np.random.default_rng(5)
    depth = 12000 + np.add.outer(np.arange(120) * 8, np.arange(160) * 3) + rng.integers(0, 40, (120, 160))
    Image.fromarray(depth.astype(np.uint16)).save(bop / "test" / "000001" / "depth" / "000000.png")
    render_templates.main(["--mesh-dir", str(ws / "meshes"), "--filelist", str(ws / "filelist.txt"),
                           "--n-poses", str(N_VIEWS), "--resolution", str(RES), "--out", str(tmp_path / "shards"),
                           "--device", "cpu"])

    def infer(out):
        return ["--dataset", str(bop), "--split", "test", "--proposals", str(ws / "props.json"),
                "--wds-dir", str(tmp_path / "shards"), "--filelist", str(ws / "filelist.txt"), "--out", str(out),
                "--layer", str(LAYER), "--depth-method", "depthmap", "--weights", str(ws / "dinov2.npz")]

    _run_jax_cli("scripts.dino_inference", infer(tmp_path / "jax.csv"), monkeypatch)
    dino_inference.main(infer(tmp_path / "torch.csv") + ["--device", "cpu"])
    ours = read_results_csv(tmp_path / "torch.csv", t_scale=1000.0)
    ref = read_results_csv(tmp_path / "jax.csv", t_scale=1000.0)
    assert len(ours) == len(ref) == 1
    for o, r in zip(ours, ref):
        assert (o.scene_id, o.im_id, o.obj_id) == (r.scene_id, r.im_id, r.obj_id)
        assert 0.05 < o.scale < 0.5  # a 60 x 50 px mask at ~1.2 m, f = 150 px
        np.testing.assert_allclose(o.scale, r.scale, rtol=1e-5)
        np.testing.assert_allclose(o.R, r.R, atol=1e-4)
        np.testing.assert_allclose(o.t * 1000.0, r.t * 1000.0, atol=1e-2)


VIDEO_SLICE_MODULES = [
    "freepose_tpu_torch.ops.sampling", "freepose_tpu_torch.datasets.video",
    *(f"freepose_tpu_torch.models.sam2.{m}" for m in ("hiera", "prompt", "mask_decoder", "model", "memory",
                                                      "video", "predictor", "convert")),
    "freepose_tpu_torch.scripts.extract_proposals_ground_video",
]
REFINE_SLICE_MODULES = [
    *(f"freepose_tpu_torch.pipeline.{m}" for m in ("online_pose_estimator", "fine_cache")),
    "freepose_tpu_torch.geometry.rotation", "freepose_tpu_torch.datasets.video",
    "freepose_tpu_torch.scripts.dino_inference_video",
]
SCALE_SLICE_MODULES = [
    *(f"freepose_tpu_torch.models.{m}" for m in ("layers", "beit", "zoedepth", "clip", "tokenizer")),
    *(f"freepose_tpu_torch.ops.{m}" for m in ("connected_components", "erosion", "knn")),
    "freepose_tpu_torch.geometry.pointcloud", "freepose_tpu_torch.geometry.camera",
    "freepose_tpu_torch.pipeline.scale_estimator",
    *(f"freepose_tpu_torch.scripts.{m}" for m in ("compute_scale", "compute_scale_video", "generate_depth_zoe")),
]

PROPOSALS_SLICE_MODULES = [
    *(f"freepose_tpu_torch.models.{m}" for m in ("wordpiece", "bert", "swin", "grounding_dino")),
    "freepose_tpu_torch.models.sam2.predictor", "freepose_tpu_torch.pipeline.proposals",
    "freepose_tpu_torch.io.npy_bank", "freepose_tpu_torch.ops.knn",
    *(f"freepose_tpu_torch.scripts.{m}" for m in ("extract_proposals_ground", "extract_proposals_ground_video",
                                                  "extract_retrieval_features", "merge_features")),
]

EVAL_SLICE_MODULES = [
    "freepose_tpu_torch.config", "freepose_tpu_torch.ops.raster_native",
    *(f"freepose_tpu_torch.evaluation.{m}" for m in ("score", "symmetry", "vos_metrics", "video_metrics",
                                                      "pose_error")),
    *(f"freepose_tpu_torch.scripts.{m}" for m in ("eval_bop_pose", "eval_videos", "sav_evaluator",
                                                  "vos_inference")),
]

ASSET_SLICE_MODULES = [
    "freepose_tpu_torch.ops.texture",
    *(f"freepose_tpu_torch.scripts.{m}" for m in ("convert_weights", "prepare_weights", "resize_meshes",
                                                  "merge_results")),
]

PROPOSALS_REST_MODULES = [
    "freepose_tpu_torch.datasets.video", "freepose_tpu_torch.datasets.bop_params",
    *(f"freepose_tpu_torch.models.sam2.{m}" for m in ("video", "predictor", "transforms", "amg", "automatic")),
    "freepose_tpu_torch.pipeline.proposals", "freepose_tpu_torch.pipeline.tracking_refiner",
    "freepose_tpu_torch.ops.cc_native", "freepose_tpu_torch.geometry.boxes",
    "freepose_tpu_torch.scripts.vis_detections_video",
]

LEFTOVERS_MODULES = [
    "freepose_tpu_torch.models.cotracker", "freepose_tpu_torch.utils.viz",
    "freepose_tpu_torch.scripts.vis_poses_video", "freepose_tpu_torch.scripts.vis_features",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import freepose_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'freepose_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'freepose_tpu', 'scripts', 'tests'))\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    mods = r.stdout.split()
    assert len(mods) >= 40 and set(VIDEO_SLICE_MODULES) <= set(mods)  # every module of the slices
    assert set(SCALE_SLICE_MODULES) <= set(mods)
    assert set(REFINE_SLICE_MODULES) <= set(mods)
    assert set(PROPOSALS_SLICE_MODULES) <= set(mods)
    assert set(EVAL_SLICE_MODULES) <= set(mods)
    assert set(ASSET_SLICE_MODULES) <= set(mods)
    assert set(PROPOSALS_REST_MODULES) <= set(mods)
    assert set(LEFTOVERS_MODULES) <= set(mods)
    # No import of JAX, the JAX package or the tests anywhere in the sources,
    # not even inside a function that this import did not run.
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|freepose_tpu|scripts|tests)\b", re.M)
    sources = [p for p in sorted((REPO / "freepose_tpu_torch").rglob("*.py")) if "_build" not in p.parts]
    for path in [REPO / "chip_smoke.py", *sources]:
        assert not pattern.search(path.read_text()), path


def test_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu(workspace):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from freepose_tpu_torch.scripts import dino_inference, render_templates
    from freepose_tpu_torch.scripts.common import load_dino_extractor

    ws = workspace
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TemplateRenderer(n_poses=2, resolution=RES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DinoFeatureExtractor(VIT_TEST)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_dino_extractor(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_templates.main(["--mesh-dir", str(ws / "meshes"), "--filelist", str(ws / "filelist.txt"),
                               "--out", str(ws / "shards_nodevice"), "--n-poses", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dino_inference.main(["--dataset", str(ws / "bop"), "--proposals", str(ws / "props.json"),
                             "--wds-dir", str(ws / "shards_nodevice"), "--filelist", str(ws / "filelist.txt"),
                             "--out", str(ws / "nodevice.csv"), "--depth-method", "const-0.1"])
    from freepose_tpu_torch.scripts import compute_scale, dino_inference_video, generate_depth_zoe

    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_depth_zoe.main(["--dataset", str(ws / "bop")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_scale.main(["--dataset", str(ws / "bop"), "--proposals", str(ws / "props.json"),
                            "--scale-file", str(ws / "props.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dino_inference_video.main(["--video-dir", str(ws), "--proposals", str(ws / "props.json"),
                                   "--wds-dir", str(ws / "shards_nodevice"), "--filelist", str(ws / "filelist.txt"),
                                   "--mesh-dir", str(ws / "meshes"), "--out", str(ws / "nodevice_video.csv")])
    from freepose_tpu_torch.scripts import extract_proposals_ground, extract_retrieval_features

    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_proposals_ground.main(["--dataset", str(ws / "bop"), "--bank", str(ws / "bank_nodevice.npy"),
                                       "--filelist", str(ws / "filelist.txt"), "--detector", "gt-masks"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_retrieval_features.main(["--wds-dir", str(ws / "shards_nodevice"), "--filelist",
                                         str(ws / "filelist.txt"), "--out", str(ws / "feats_nodevice")])
    assert TemplateRenderer(n_poses=2, resolution=RES, device="cpu").poses.device.type == "cpu"
