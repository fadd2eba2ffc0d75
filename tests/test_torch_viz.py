"""The port's feature and pose visualisation (utils/viz.py and the
vis_features and vis_poses_video CLIs) against the JAX package's, on the
CPU.

A principal component's sign is arbitrary, and each package's SVD picks its
own: a flipped component maps a channel c to 1 - c after the min-max
normalisation. So pca_rgb is held to JAX channel by channel up to that
flip, within 1e-5 (fp32 SVDs of well-separated spectra), and the CLIs'
PCA tiles (uint8) within one level of JAX's or of its flip. The CLIs run
in-process on a tiny scene (FREEPOSE_TINY_MODELS=1: VIT_TEST, one .npz of
its JAX weights; a coloured blob mesh, 4 frames at 72 x 96, 96² renders):
the image and mask tiles are identical, and the pose overlays are
identical wherever both packages' render masks agree on a pixel and its
4 neighbours (the outline reads them).
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freepose_tpu.utils import viz as jviz
from freepose_tpu_torch.utils import viz

H, W, N_FRAMES, RENDER = 72, 96, 4, 96
MESH = "blobmesh"
SCALE = 0.2


def _same_up_to_sign(ours, ref, atol, one=1.0):
    """Each channel of [..., 3] equals JAX's c or its flip one - c (255 - c
    for uint8 tiles)."""
    for ch in range(3):
        o, r = ours[..., ch].astype(np.float64), ref[..., ch].astype(np.float64)
        err = min(np.abs(o - r).max(), np.abs(o - (one - r)).max())
        assert err <= atol, (ch, err)


def test_pca_rgb_matches_jax_up_to_sign():
    feats = np.random.default_rng(0).normal(size=(8, 10, 32)).astype(np.float32)
    rgb = viz.pca_rgb(torch.as_tensor(feats)).numpy()
    assert rgb.shape == (8, 10, 3) and rgb.min() >= 0 and rgb.max() <= 1 + 1e-6
    _same_up_to_sign(rgb, np.asarray(jviz.pca_rgb(jnp.asarray(feats))), 1e-5)


def test_pca_rgb_masked_fit_and_black_background():
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(6, 6, 16)).astype(np.float32)
    mask = np.zeros((6, 6), bool)
    mask[1:5, 2:5] = True
    rgb = viz.pca_rgb(torch.as_tensor(feats), torch.as_tensor(mask)).numpy()
    assert (rgb[~mask] == 0).all() and rgb[mask].max() > 0
    ref = np.asarray(jviz.pca_rgb(jnp.asarray(feats), jnp.asarray(mask)))
    _same_up_to_sign(rgb[mask], ref[mask], 1e-5)
    # The basis is fit on the masked-in features only: the outside cannot move it.
    feats[~mask] = rng.normal(size=(int((~mask).sum()), 16)) * 100
    np.testing.assert_allclose(viz.pca_rgb(torch.as_tensor(feats), torch.as_tensor(mask)).numpy(), rgb, atol=1e-5)


def test_nearest_upscale_matches_jax():
    img = np.arange(6).reshape(2, 3, 1)
    up = viz.nearest_upscale(img, 2)
    np.testing.assert_array_equal(up, jviz.nearest_upscale(img, 2))
    assert up.shape == (4, 6, 1) and (up[0:2, 0:2, 0] == 0).all() and (up[2:4, 4:6, 0] == 5).all()


def test_feature_panel_layout_matches_jax():
    rng = np.random.default_rng(2)
    h, w, patch = 4, 5, 14
    feats = rng.normal(size=(h, w, 8)).astype(np.float32)
    image = (rng.random((h * patch, w * patch, 3)) * 255).astype(np.uint8)
    mask = rng.random((h, w)) > 0.5
    panel = viz.feature_panel(image, torch.as_tensor(feats), mask=mask, patch=patch)
    ref = jviz.feature_panel(image, feats, mask=mask, patch=patch)
    assert panel.dtype == np.uint8 and panel.shape == ref.shape == (h * patch, 4 * w * patch, 3)
    tile = w * patch
    for i in (0, 2):  # image and mask tiles
        np.testing.assert_array_equal(panel[:, i * tile:(i + 1) * tile], ref[:, i * tile:(i + 1) * tile])
    _check_pca_tiles(panel, ref, tile)
    assert viz.feature_panel(image, feats, patch=patch).shape == (h * patch, 2 * w * patch, 3)


def _check_pca_tiles(panel, ref, tile):
    """A panel's PCA tiles against JAX's within one 8-bit level up to each
    channel's sign: the plain one everywhere, the masked one on the pixels
    its mask tile keeps (the rest black in both)."""
    _same_up_to_sign(panel[:, tile:2 * tile], ref[:, tile:2 * tile], 1, 255)
    keep = panel[:, 2 * tile:3 * tile, 0] == 255
    masked, masked_ref = panel[:, 3 * tile:], ref[:, 3 * tile:]
    assert keep.any() and (masked[~keep] == 0).all() and (masked_ref[~keep] == 0).all()
    _same_up_to_sign(masked[keep], masked_ref[keep], 1, 255)


# ---------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from scipy.spatial.transform import Rotation

    from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
    from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
    from freepose_tpu_torch.io.bop_csv import PoseResult, write_results_csv
    from freepose_tpu_torch.io.mesh import save_obj
    from scripts.common import save_params
    from tests.test_torch_smooth_slice import _blob

    ws = tmp_path_factory.mktemp("torch_viz")
    (ws / "meshes" / MESH).mkdir(parents=True)
    save_obj(_blob(), ws / "meshes" / MESH / f"{MESH}.obj")
    rng = np.random.default_rng(0)
    (ws / "frames").mkdir()
    (ws / "masks").mkdir()
    rows = []
    for t in range(N_FRAMES):
        Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(ws / "frames" / f"{t:06d}.png")
        Image.fromarray(((rng.random((H, W)) > 0.5) * 255).astype(np.uint8)).save(ws / "masks" / f"{t:06d}.png")
        rot = Rotation.from_rotvec([0.3 * t, 0.2, 0.1 * t]).as_matrix()
        rows.append(PoseResult(scene_id=0, im_id=t, obj_id=MESH, score=0.5, R=rot,
                               t=np.array([0.02 * t - 0.03, 0.01, 0.9]), bbox_visib=np.array([0, 0, 10, 10.0]),
                               scale=SCALE))
    write_results_csv(rows[::-1], ws / "poses.csv", t_scale=1.0)  # the CLIs sort by frame
    params = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    save_params(jax.tree_util.tree_map(np.array, params), ws / "dinov2.npz")
    return ws


def _saved_arrays(monkeypatch, run):
    """Run `run` with PIL's save recording each image's pixels by name."""
    saved = {}
    real = Image.Image.save

    def record(self, fp, *args, **kwargs):
        saved[str(fp).rsplit("/", 1)[-1]] = np.asarray(self).copy()
        return real(self, fp, *args, **kwargs)

    monkeypatch.setattr(Image.Image, "save", record)
    run()
    monkeypatch.setattr(Image.Image, "save", real)
    return saved


def _run_both(name, argv_jax, argv_port, monkeypatch):
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    module = importlib.import_module(f"scripts.{name}")

    def run_jax():
        monkeypatch.setattr(sys, "argv", [name, *argv_jax])
        module.main()

    port = importlib.import_module(f"freepose_tpu_torch.scripts.{name}")
    return (_saved_arrays(monkeypatch, lambda: port.main([*argv_port, "--device", "cpu"])),
            _saved_arrays(monkeypatch, run_jax))


def _render_masks(ws):
    """Both packages' frame-size render masks of every row, as the CLIs
    compute them."""
    from freepose_tpu.geometry.camera import default_video_intrinsics as jax_intrinsics
    from freepose_tpu.io.mesh import load_obj as jax_load_obj
    from freepose_tpu.io.mesh import pad_mesh as jax_pad_mesh
    from freepose_tpu.ops.rasterizer import RasterSettings as JaxSettings
    from freepose_tpu.ops.rasterizer import rasterize as jax_rasterize
    from freepose_tpu.ops.sampling import resize_bilinear as jax_resize
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.io.bop_csv import read_results_csv
    from freepose_tpu_torch.io.mesh import load_obj, pad_mesh
    from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize
    from freepose_tpu_torch.ops.sampling import resize_bilinear

    rows = sorted(read_results_csv(ws / "poses.csv", t_scale=1.0), key=lambda r: r.im_id)
    poses = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in rows]).astype(np.float32)
    path = ws / "meshes" / MESH / f"{MESH}.obj"
    s = RENDER / max(H, W)
    scale = np.array([[s], [s], [1]])
    arrays = pad_mesh(load_obj(path).normalized().scaled(SCALE), 16384, 32768)
    _, depth = rasterize(*(torch.as_tensor(a) for a in arrays), torch.as_tensor(poses),
                         torch.as_tensor(default_video_intrinsics(W, H).numpy() * scale, dtype=torch.float32),
                         RasterSettings(resolution=RENDER, tile=32, max_faces_per_tile=256))
    ours = (resize_bilinear((depth > 0).float(), (H, W)) > 0.5).numpy()
    jarrays = jax_pad_mesh(jax_load_obj(path).normalized().scaled(SCALE), 16384, 32768)
    _, jdepth = jax_rasterize(*(jnp.asarray(a) for a in jarrays), jnp.asarray(poses),
                              jnp.asarray(np.asarray(jax_intrinsics(W, H)) * scale, jnp.float32),
                              JaxSettings(resolution=RENDER, tile=32, max_faces_per_tile=256))
    ref = np.asarray(jax_resize((jdepth > 0).astype(jnp.float32), (H, W))) > 0.5
    return ours, ref


def test_vis_poses_video_matches_jax(scene, monkeypatch):
    ws = scene
    argv = ["--video-dir", str(ws / "frames"), "--poses", str(ws / "poses.csv"), "--mesh-dir", str(ws / "meshes"),
            "--render-size", str(RENDER)]
    ours, ref = _run_both("vis_poses_video", [*argv, "--out-dir", str(ws / "jax_overlays")],
                          [*argv, "--out-dir", str(ws / "torch_overlays")], monkeypatch)
    names = [f"{t:06d}.jpg" for t in range(N_FRAMES)]
    assert sorted(ours) == sorted(ref) == names  # one overlay per row
    assert all((ws / "torch_overlays" / n).exists() for n in names)
    masks, jmasks = _render_masks(ws)
    assert masks.any(axis=(1, 2)).all()
    for i, name in enumerate(names):
        agree = masks[i] == jmasks[i]
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            agree &= np.roll(masks[i] == jmasks[i], (dy, dx), axis=(0, 1))
        assert agree.mean() > 0.98
        np.testing.assert_array_equal(ours[name][agree], ref[name][agree])
        frame = np.asarray(Image.open(ws / "frames" / f"{i:06d}.png"))
        assert (ours[name][masks[i]] != frame[masks[i]]).any()  # the render is blended in


def test_vis_features_matches_jax(scene, monkeypatch):
    ws = scene
    images = [str(ws / "frames" / f"{t:06d}.png") for t in range(3)]
    argv = ["--images", *images, "--weights", str(ws / "dinov2.npz"), "--layer", "2", "--masks", str(ws / "masks")]
    ours, ref = _run_both("vis_features", [*argv, "--out", str(ws / "jax_feats")],
                          [*argv, "--out", str(ws / "torch_feats")], monkeypatch)
    names = [f"{t:06d}_feats.png" for t in range(3)]
    assert sorted(ours) == sorted(ref) == names
    tile = 56  # VIT_TEST's square: a 4 x 4 patch grid
    for name in names:
        assert ours[name].shape == ref[name].shape == (tile, 4 * tile, 3)
        for i in (0, 2):  # the resized image and the mask
            np.testing.assert_array_equal(ours[name][:, i * tile:(i + 1) * tile], ref[name][:, i * tile:(i + 1) * tile])
        _check_pca_tiles(ours[name], ref[name], tile)
