"""Tile rasterizer (K1 and its plain version) in the PyTorch port vs the JAX
package, on the same numpy meshes, poses and intrinsics.

The port projects vertices with the same rounding as XLA's CPU dot, so
selection and hit masks are required to be identical; depth and rgb agree
to atol 1e-5 (the JAX Pallas kernel shades colour in another association
order). The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.geometry.rotation import template_poses as jax_template_poses
from freepose_tpu.io.mesh import TriMesh, pad_mesh
from freepose_tpu.ops.rasterizer import RasterSettings as JaxSettings
from freepose_tpu.ops.rasterizer import rasterize as jax_rasterize
from freepose_tpu.ops.rasterizer import select_tile_faces as jax_select
from freepose_tpu.ops.rasterizer_pallas import rasterize_pallas
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize, select_tile_faces
from freepose_tpu_torch.ops.rasterizer_cuda import (
    _bin_and_pack,
    raster_tile,
    raster_tile_plain,
    rasterize_cuda,
)

K = np.asarray([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)


def _cube():
    h = 0.5
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                  [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)
    colors = np.random.default_rng(5).random((8, 3)).astype(np.float32)
    return TriMesh(v, f, colors)


def _bumpy_sphere(n_lat=10, n_lon=14, seed=0):
    rng = np.random.default_rng(seed)
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 0.4 + 0.1 * np.sin(3 * ph)
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    v = np.asarray(verts, np.float32)
    return TriMesh(v, np.asarray(faces, np.int32), rng.random((len(v), 3)).astype(np.float32))


CASES = {
    "cube": dict(mesh=_cube, z=2.5, depth_only=False, per_pose_k=False),
    "sphere": dict(mesh=_bumpy_sphere, z=1.1, depth_only=False, per_pose_k=False),
    "depth_only": dict(mesh=_bumpy_sphere, z=1.1, depth_only=True, per_pose_k=False),
    "per_pose_k": dict(mesh=_bumpy_sphere, z=1.1, depth_only=False, per_pose_k=True),
}


def _inputs(case):
    v, c, f, valid = pad_mesh(case["mesh"](), 256, 512)
    poses = np.array(jax_template_poses(3, z=case["z"]))  # writable copy
    k = K
    if case["per_pose_k"]:
        k = np.stack([K * np.array([[s], [s], [1.0]], np.float32) for s in (0.8, 1.0, 1.25)])
    return v, c, f, valid, poses, k


def _selection_inputs():
    rng = np.random.default_rng(1)
    grid, tile, nf = 5, 16, 400
    res = grid * tile
    lo = rng.uniform(-10, res + 10, size=(nf, 2)).astype(np.float32)
    ext = rng.gamma(1.0, 6.0, size=(nf, 2)).astype(np.float32)
    ext[:10] = res * 0.9  # faces spanning more than the 4x4 small-face window
    ext[10:16, 0] = res * 0.9
    hi = lo + ext
    lo[20:40] = np.round(lo[20:40] / tile) * tile  # bboxes exactly on tile edges
    hi[40:60] = np.round(hi[40:60] / tile) * tile
    valid = rng.random(nf) > 0.1
    return lo, hi, valid, grid, tile


@pytest.mark.parametrize("binning", ["sort", "topk"])
def test_select_tile_faces_matches_jax(binning):
    lo, hi, valid, grid, tile = _selection_inputs()
    m = 64  # tiles with more than m candidates cap at the m lowest indices
    j_idx, j_ok = jax_select(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid), grid, tile, m, binning)
    t_idx, t_ok = select_tile_faces(torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(valid),
                                    grid, tile, m, binning)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(torch.where(t_ok, t_idx, -1).numpy(),
                                  np.where(np.asarray(j_ok), np.asarray(j_idx), -1))
    assert t_ok.any() and not t_ok.all()


def test_select_tile_faces_batched_over_poses():
    lo, hi, valid, grid, tile = _selection_inputs()
    lo_b = torch.as_tensor(np.stack([lo, lo + 3.0]))
    hi_b = torch.as_tensor(np.stack([hi, hi + 3.0]))
    valid_b = torch.as_tensor(np.stack([valid, valid]))
    idx, ok = select_tile_faces(lo_b, hi_b, valid_b, grid, tile, 64)
    for i in range(2):
        idx1, ok1 = select_tile_faces(lo_b[i], hi_b[i], valid_b[i], grid, tile, 64)
        torch.testing.assert_close(ok[i], ok1, rtol=0, atol=0)
        torch.testing.assert_close(torch.where(ok[i], idx[i], -1), torch.where(ok1, idx1, -1), rtol=0, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_rasterize_matches_jax(name):
    case = CASES[name]
    v, c, f, valid, poses, k = _inputs(case)
    settings = dict(resolution=64, tile=32, max_faces_per_tile=128, depth_only=case["depth_only"])
    jargs = [jnp.asarray(a) for a in (v, c, f, valid, poses, k)]
    targs = [torch.as_tensor(a) for a in (v, c, f, valid, poses, k)]
    rgb_x, d_x = (np.asarray(a) for a in jax_rasterize(*jargs, JaxSettings(backend="xla", **settings)))
    rgb_p, d_p = (np.asarray(a) for a in rasterize_pallas(*jargs, JaxSettings(**settings), interpret=True))
    rgb, depth = rasterize(*targs, RasterSettings(**settings))  # CPU tensor: plain version
    rgb_k, depth_k = rasterize_cuda(*targs, RasterSettings(**settings))  # prologue + K1's plain version
    assert (d_x > 0).any()
    for r_ours, d_ours in ((rgb, depth), (rgb_k, depth_k)):
        for r_ref, d_ref in ((rgb_x, d_x), (rgb_p, d_p)):
            np.testing.assert_array_equal(d_ours.numpy() > 0, d_ref > 0)
            np.testing.assert_allclose(d_ours.numpy(), d_ref, atol=1e-5)
            np.testing.assert_allclose(r_ours.numpy(), r_ref, atol=1e-5)
    # The plain rasterizer and the packed-tile path round identically.
    torch.testing.assert_close(depth_k, depth, rtol=0, atol=0)
    torch.testing.assert_close(rgb_k, rgb, rtol=0, atol=0)


def test_binning_modes_render_identically():
    v, c, f, valid, poses, k = (torch.as_tensor(a) for a in _inputs(CASES["cube"]))
    for mcap in (4, 64):  # 4: the per-tile cap binds; 64: it does not
        outs = [rasterize(v, c, f, valid, poses, k,
                          RasterSettings(resolution=64, tile=32, max_faces_per_tile=mcap, binning=b))
                for b in ("sort", "topk")]
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_kernel_backend_on_cpu_tensor_raises():
    v, c, f, valid, poses, k = (torch.as_tensor(a) for a in _inputs(CASES["cube"]))
    for backend in ("pallas", "kernel"):
        with pytest.raises(ValueError):
            rasterize(v, c, f, valid, poses, k, RasterSettings(resolution=64, tile=32, backend=backend))


def test_raster_tile_cpu_runs_plain_version_without_launch():
    v, c, f, valid, poses, k = (torch.as_tensor(a) for a in _inputs(CASES["sphere"]))
    settings = RasterSettings(resolution=64, tile=32, max_faces_per_tile=128)
    attrs, origins = _bin_and_pack(v, c, f, valid, poses, k.expand(3, 3, 3), settings)
    before = raster_tile.launches
    out = raster_tile(attrs, origins, 32, settings.ambient, False)
    assert raster_tile.launches == before
    torch.testing.assert_close(out, raster_tile_plain(attrs, origins, 32, settings.ambient, False),
                               rtol=0, atol=0)

