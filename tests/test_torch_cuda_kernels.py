"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without a GPU.

The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit (tests/conftest.py imports JAX,
hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: K2 in bf16 atol/rtol 2e-2 (outputs of O(1) size rounded to
bf16, and the kernel's online softmax rescales p in another order than the
one-pass plain version before p is rounded); K2 in fp32 atol/rtol 1e-5. K1
runs the plain version's fp32 operations in the same order (built without
FMA contraction): hit masks identical, depth and rgb to atol 1e-6.
"""
import numpy as np
import pytest
import torch

from freepose_tpu_torch.geometry.rotation import template_poses
from freepose_tpu_torch.io.mesh import TriMesh, pad_mesh
from freepose_tpu_torch.ops.attention import dense_attention, flash_attention
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize
from freepose_tpu_torch.ops.rasterizer_cuda import _bin_and_pack, raster_tile, raster_tile_plain

pytestmark = pytest.mark.cuda

SCALE = 64**-0.5
K = np.asarray([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(n, b=2, h=4, d=64, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n", [905, 37, 64])
def test_k2_matches_plain(cuda, dtype, tol, n):
    q, k, v = (torch.as_tensor(x, device=cuda).to(dtype) for x in _qkv(n))
    before = flash_attention.launches
    out = flash_attention(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = dense_attention(q, k, v, SCALE)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_k2_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim other than 64
        flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(), q[..., :32].contiguous(), SCALE)
    with pytest.raises(ValueError):  # not contiguous
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), SCALE)
    with pytest.raises(ValueError):  # device mismatch
        flash_attention(q, q.cpu(), q, SCALE)
    with pytest.raises(TypeError):  # fp16 is not a K2 dtype
        flash_attention(q.half(), q.half(), q.half(), SCALE)


def _cube():
    h = 0.5
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                  [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)
    return TriMesh(v, f, np.random.default_rng(5).random((8, 3)).astype(np.float32))


def _bumpy_sphere(n_lat=10, n_lon=14):
    rng = np.random.default_rng(0)
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


@pytest.mark.parametrize("name", list(CASES))
def test_k1_matches_plain(cuda, name):
    case = CASES[name]
    k = K
    if case["per_pose_k"]:
        k = np.stack([K * np.array([[s], [s], [1.0]], np.float32) for s in (0.8, 1.0, 1.25)])
    v, c, f, valid = (torch.as_tensor(a, device=cuda) for a in pad_mesh(case["mesh"](), 256, 512))
    poses = template_poses(3, z=case["z"], device=cuda)
    k = torch.as_tensor(k, device=cuda)
    settings = RasterSettings(resolution=64, tile=32, max_faces_per_tile=128, depth_only=case["depth_only"])
    attrs, origins = _bin_and_pack(v, c, f, valid, poses, k.expand(3, 3, 3), settings)
    before = raster_tile.launches
    out = raster_tile(attrs, origins, 32, settings.ambient, settings.depth_only)
    torch.cuda.synchronize()
    assert raster_tile.launches == before + 1
    ref = raster_tile_plain(attrs, origins, 32, settings.ambient, settings.depth_only)
    assert bool((ref[..., 0] > 0).any())
    torch.testing.assert_close(out[..., 0] > 0, ref[..., 0] > 0, rtol=0, atol=0)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    # The whole renderer: kernel path ("auto" on a CUDA tensor) vs plain.
    rgb, depth = rasterize(v, c, f, valid, poses, k, settings)
    assert raster_tile.launches == before + 2
    plain = RasterSettings(**{**settings.__dict__, "backend": "xla"})
    rgb_p, depth_p = rasterize(v, c, f, valid, poses, k, plain)
    torch.testing.assert_close(depth > 0, depth_p > 0, rtol=0, atol=0)
    torch.testing.assert_close(depth, depth_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(rgb, rgb_p, rtol=0, atol=1e-6)


def test_k1_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    attrs = torch.zeros((4, 32, 16), device=cuda)
    origins = torch.zeros((4, 2), device=cuda)
    with pytest.raises(TypeError):
        raster_tile(attrs.double(), origins, 8, 1.0, False)
    with pytest.raises(ValueError):
        raster_tile(attrs[:, :16], origins, 8, 1.0, False)
    with pytest.raises(ValueError):
        raster_tile(attrs, origins.cpu(), 8, 1.0, False)
