"""Textured rendering (ops/texture.py) in the PyTorch port vs the JAX package,
on the same seeded numpy meshes, atlases, poses and intrinsics.

Tolerances:
- `sample_texture` and `shade_uv_image` on the same UVs: within 1e-6 (the
  same float32 operations; an atlas value is at most 1).
- `render_textured` against the JAX XLA path: identical hit masks, depth and
  the interpolated (u, v, w) within 1e-5 (the rasterizers' agreement,
  tests/test_torch_rasterizer.py). Bilinear RGB then differs by at most what
  that UV error moves a sample: 1e-5 of a UV unit is 1e-5·(Wt−1) texels,
  and one texel moves a bilinear sample by at most the largest step between
  neighbouring texels, per axis, times the ambient factor before the clip:
  RGB_TOL = ambient·1e-5·((Wt−1) + (Ht−1))·step + 1e-6.
- Through `TemplateRenderer`, `TemplateBank.build_pack` and the
  `render_templates` CLI the same bounds hold; the shards' PNGs quantise, so
  RGB may differ by one level of 1/255 and depth by one millimetre step, as
  tests/test_torch_slice.py allows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freepose_tpu.io.mesh import load_obj as jax_load_obj
from freepose_tpu.ops.rasterizer import RasterSettings as JaxSettings
from freepose_tpu.ops.rasterizer import render_meshes as jax_render_meshes
from freepose_tpu.ops.texture import render_textured as jax_render_textured
from freepose_tpu.ops.texture import sample_texture as jax_sample_texture
from freepose_tpu.ops.texture import shade_uv_image as jax_shade_uv_image
from freepose_tpu.pipeline.renderer import TemplateRenderer as JaxRenderer
from freepose_tpu_torch.io.mesh import load_obj
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize, render_meshes
from freepose_tpu_torch.ops.texture import render_textured, sample_texture, shade_uv_image
from freepose_tpu_torch.pipeline.renderer import TemplateRenderer

RES = 64
K = np.array([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], np.float32)
SETTINGS = dict(resolution=RES, tile=16, max_faces_per_tile=8)
UV_ATOL = 1e-5


def _quad(z_far: float = 0.0):
    """Unit quad in the z = 2 plane (right edge at 2 + z_far), UVs over the
    whole atlas."""
    v = np.array([[-1, -1, 2.0], [1, -1, 2.0 + z_far], [1, 1, 2.0 + z_far], [-1, 1, 2.0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvw = np.array([[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    return v, f, uvw


def _atlas(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Seeded non-constant atlas: coloured cells plus noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    cells = rng.random((4, 4, 3))
    y, x = np.mgrid[0:h, 0:w]
    tex = cells[y * 4 // h, x * 4 // w] + 0.2 * rng.random((h, w, 3))
    return np.clip(tex, 0, 1).astype(np.float32)


def _poses(n: int, seed: int = 1) -> np.ndarray:
    """Small seeded rotations about the quad's centre, camera at the origin."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a, b = rng.uniform(-0.5, 0.5, 2)
        ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
        r = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]]) @ np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]])
        poses[i, :3, :3] = r
        poses[i, :3, 3] = np.array([0, 0, 2.0]) - r @ np.array([0, 0, 2.0])
    return poses


def _rgb_tol(tex: np.ndarray, ambient: float) -> float:
    step = max(np.abs(np.diff(tex, axis=0)).max(), np.abs(np.diff(tex, axis=1)).max())
    h, w = tex.shape[:2]
    return ambient * UV_ATOL * ((w - 1) + (h - 1)) * step + 1e-6


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_sample_texture_matches_jax(method):
    rng = np.random.default_rng(3)
    tex = rng.random((13, 17, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (5, 7, 2)).astype(np.float32)  # some outside [0, 1]: clamped
    uv[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    ours = sample_texture(torch.as_tensor(uv), torch.as_tensor(tex), method).numpy()
    ref = np.asarray(jax_sample_texture(jnp.asarray(uv), jnp.asarray(tex), method=method))
    assert ours.shape == (5, 7, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_shade_uv_image_on_the_jax_uv_image():
    """JAX's own UV pass shaded by both packages; a third of the vertices
    have no vt (w = 0), so some pixels fall back to grey."""
    v, f, uvw = _quad(z_far=1.0)
    uvw = uvw.copy()
    uvw[1, 2] = 0.0
    tex = _atlas(24, 32)
    poses = _poses(3)
    settings = JaxSettings(**SETTINGS, backend="xla", ambient=1.0)
    uv_img, depth = jax_render_meshes(jnp.asarray(v), jnp.asarray(uvw), jnp.asarray(f), jnp.ones(2, bool),
                                      jnp.asarray(poses), jnp.asarray(K), settings)
    uv_img, depth = np.asarray(uv_img), np.asarray(depth)
    assert (depth > 0).any() and (uv_img[..., 2][depth > 0] < 0.999).any()
    for ambient in (1.0, 2.0):
        ours = shade_uv_image(torch.as_tensor(uv_img), torch.as_tensor(depth), torch.as_tensor(tex), ambient)
        ref = jax_shade_uv_image(jnp.asarray(uv_img), jnp.asarray(depth), jnp.asarray(tex), ambient)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), atol=1e-6)
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("ambient", [1.0, 2.0])
def test_render_textured_matches_jax(ambient):
    """Five poses in chunks of two (the last chunk short) against JAX's XLA
    path in one batch: chunked shading changes no pixel."""
    v, f, uvw = _quad(z_far=1.0)
    tex = _atlas(32, 48)
    poses = _poses(5)
    args = (v, uvw, f, np.ones(2, bool), poses, K)
    ours = render_textured(*map(torch.as_tensor, args), torch.as_tensor(tex),
                           RasterSettings(**SETTINGS, ambient=ambient), pose_chunk=2)
    ref = jax_render_textured(*map(jnp.asarray, args), jnp.asarray(tex),
                              JaxSettings(**SETTINGS, backend="xla", ambient=ambient))
    rgb, depth = ours[0].numpy(), ours[1].numpy()
    ref_rgb, ref_depth = np.asarray(ref[0]), np.asarray(ref[1])
    assert rgb.shape == (5, RES, RES, 3) and (depth > 0).sum() > 1000
    np.testing.assert_array_equal(depth > 0, ref_depth > 0)
    np.testing.assert_allclose(depth, ref_depth, atol=UV_ATOL)
    np.testing.assert_allclose(rgb, ref_rgb, atol=_rgb_tol(tex, ambient))

    # The UV pass itself: (u, v, w) within UV_ATOL.
    uv_ours = render_meshes(*map(torch.as_tensor, args), RasterSettings(**SETTINGS, ambient=1.0))[0].numpy()
    uv_ref = np.asarray(jax_render_meshes(*map(jnp.asarray, args), JaxSettings(**SETTINGS, backend="xla",
                                                                                ambient=1.0))[0])
    np.testing.assert_allclose(uv_ours, uv_ref, atol=UV_ATOL)


def test_textured_matches_bake_on_constant_atlas():
    v, f, uvw = _quad()
    tex = np.full((8, 8, 3), 0.25, np.float32)
    settings = RasterSettings(**SETTINGS)
    args = [torch.as_tensor(a) for a in (v, uvw, f, np.ones(2, bool), _poses(2), K)]
    rgb_t, d_t = render_textured(*args, torch.as_tensor(tex), settings)
    args[1] = torch.full((4, 3), 0.25)
    rgb_b, d_b = rasterize(*args, settings)
    np.testing.assert_array_equal(d_t.numpy(), d_b.numpy())
    np.testing.assert_allclose(rgb_t.numpy(), rgb_b.numpy(), atol=1e-6)


def test_no_vt_vertices_fall_back_to_gray():
    v, f, uvw = _quad()
    uvw = uvw.copy()
    uvw[:, 2] = 0.0
    settings = RasterSettings(**SETTINGS)
    rgb, depth = render_textured(*map(torch.as_tensor, (v, uvw, f, np.ones(2, bool), _poses(1), K)),
                                 torch.as_tensor(_atlas(16, 16)), settings)
    hit = depth[0].numpy() > 0
    assert hit.sum() > 1000
    np.testing.assert_allclose(rgb[0].numpy()[hit], np.clip(0.7 * settings.ambient, 0, 1), atol=1e-6)
    assert not rgb[0].numpy()[~hit].any()


def _textured_octahedron(root, tex_hw=(32, 48)):
    """A textured OBJ (per-face UVs, an MTL and a seeded PNG atlas) under
    root/octa/octa.obj."""
    d = root / "octa"
    d.mkdir(parents=True, exist_ok=True)
    Image.fromarray((_atlas(*tex_hw, seed=5) * 255).astype(np.uint8)).save(d / "atlas.png")
    (d / "octa.mtl").write_text("newmtl m\nmap_Kd atlas.png\n")
    vs = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    fs = [(1, 3, 5), (3, 2, 5), (2, 4, 5), (4, 1, 5), (3, 1, 6), (2, 3, 6), (4, 2, 6), (1, 4, 6)]
    lines = ["mtllib octa.mtl"] + [f"v {a} {b} {c}" for a, b, c in vs]
    lines += ["vt 0.05 0.1", "vt 0.9 0.2", "vt 0.4 0.95"]
    lines += [f"f {a}/1 {b}/2 {c}/3" for a, b, c in fs]
    (d / "octa.obj").write_text("\n".join(lines) + "\n")
    return d / "octa.obj"


def _renderers(texture_mode, res=48):
    kw = dict(n_poses=6, resolution=res, max_vertices=512, max_faces=1024, pose_chunk=4, texture_mode=texture_mode)
    st = dict(resolution=res, tile=16, max_faces_per_tile=64)
    return (TemplateRenderer(**kw, settings=RasterSettings(**st), device="cpu"),
            JaxRenderer(**kw, settings=JaxSettings(**st, backend="xla")))


@pytest.mark.parametrize("texture_mode", ["auto", "bake"])
def test_template_renderer_matches_jax_on_a_textured_obj(tmp_path, texture_mode):
    path = _textured_octahedron(tmp_path)
    mesh, jmesh = load_obj(path).normalized(), jax_load_obj(path).normalized()
    assert mesh.texture is not None and mesh.uv is not None
    ours, ref = _renderers(texture_mode)
    rgb, depth = (x.numpy() for x in ours.render(mesh))
    ref_rgb, ref_depth = (np.asarray(x) for x in ref.render(jmesh))
    np.testing.assert_array_equal(depth > 0, ref_depth > 0)
    np.testing.assert_allclose(depth, ref_depth, atol=UV_ATOL)
    np.testing.assert_allclose(rgb, ref_rgb, atol=_rgb_tol(mesh.texture, ours.settings.ambient))
    if texture_mode == "auto":  # the atlas was sampled: not the bake
        bake_rgb = _renderers("bake")[0].render(mesh)[0].numpy()
        assert np.abs(rgb - bake_rgb).max() > 0.2


def test_build_pack_on_a_textured_obj_matches_jax(tmp_path):
    import jax

    from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
    from freepose_tpu.models.dinov2 import DinoFeatureExtractor as JaxExtractor
    from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
    from freepose_tpu.pipeline.template_bank import TemplateBank as JaxBank
    from freepose_tpu_torch.models.dinov2 import VIT_TEST, DinoFeatureExtractor
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank

    path = _textured_octahedron(tmp_path)
    params = jax.tree_util.tree_map(np.array, JaxDinoV2(JAX_VIT_TEST).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"])
    ours, ref = _renderers("auto", res=56)  # crops the ViT's 14-px patches tile
    ext = DinoFeatureExtractor(VIT_TEST, params=params, device="cpu")
    jext = JaxExtractor(JAX_VIT_TEST, params=params)
    pack = TemplateBank(lambda x: ext(x, layer=2), renderer=ours, batch_size=4).build_pack(
        "octa", load_obj(path).normalized())
    jpack = JaxBank(lambda x: jext(x, layer=2), renderer=ref, batch_size=4).build_pack(
        "octa", jax_load_obj(path).normalized())
    np.testing.assert_allclose(pack.feats.numpy(), np.asarray(jpack.feats), atol=1e-4)
    for name in ("pc_min", "pc_max", "pc_mean"):
        np.testing.assert_allclose(getattr(pack, name).numpy(), np.asarray(getattr(jpack, name)), atol=1e-5)


def test_render_templates_cli_on_a_textured_obj_matches_jax(tmp_path, monkeypatch):
    import importlib
    import sys

    from freepose_tpu_torch.datasets.template import WebTemplateDataset
    from freepose_tpu_torch.scripts import render_templates

    monkeypatch.setenv("FREEPOSE_TEMPLATE_VIEWS", "4")
    _textured_octahedron(tmp_path / "meshes")
    (tmp_path / "filelist.txt").write_text("octa\n")
    argv = ["--mesh-dir", str(tmp_path / "meshes"), "--filelist", str(tmp_path / "filelist.txt"),
            "--n-poses", "4", "--resolution", "56"]
    monkeypatch.setattr(sys, "argv", ["render_templates", *argv, "--out", str(tmp_path / "jax")])
    importlib.import_module("scripts.render_templates").main()
    render_templates.main([*argv, "--out", str(tmp_path / "torch"), "--device", "cpu"])
    ours = WebTemplateDataset(tmp_path / "torch", ["octa"]).get_template_by_name("octa")
    ref = WebTemplateDataset(tmp_path / "jax", ["octa"]).get_template_by_name("octa")
    assert (ours["depth"] > 0).sum() > 500
    np.testing.assert_array_equal(ours["depth"] > 0, ref["depth"] > 0)
    np.testing.assert_allclose(ours["depth"], ref["depth"], atol=1.01e-3)
    np.testing.assert_allclose(ours["rgb"], ref["rgb"], atol=1.01 / 255)
