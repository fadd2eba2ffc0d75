"""EPnP, Kabsch, reprojection error, SE(3) smoothing and the crop camera
math of the PyTorch port vs the JAX package, on the same seeded numpy inputs.

Tolerances: EPnP poses within 2e-5 with 6 or more valid points, noisy or
not (fp32 solves summed in another order; both packages' eigen-solves are
LAPACK's ssyevd, so the eigenvectors' signs, which set the control points,
agree); a wrong null-space sign or scale would be O(1) off. With exactly 4
valid points the 8 x 12 system has a 4-dimensional null space, whose basis
ssyevd picks from rounding-level differences of its input (the two packages
agree on some inputs and not on others), so there the port is held to being
a finite rotation, and with no valid point to the JAX function's fallback. Smoothing within 1e-5; camera math within
1e-4 pixels (boxes of hundreds of pixels).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from freepose_tpu.geometry import camera as jax_camera
from freepose_tpu.geometry import se3 as jax_se3
from freepose_tpu.geometry.rotation import average_quaternions as jax_average_quaternions
from freepose_tpu.geometry.rotation import matrix_to_quat as jax_matrix_to_quat
from freepose_tpu.geometry.rotation import matrix_to_rotvec as jax_matrix_to_rotvec
from freepose_tpu.pipeline import pnp as jax_pnp
from freepose_tpu.pipeline.tracking_refiner import _epnp_batch as jax_epnp_batch
from freepose_tpu_torch.geometry import camera, se3
from freepose_tpu_torch.geometry.rotation import average_quaternions, matrix_to_quat, matrix_to_rotvec
from freepose_tpu_torch.pipeline import pnp
from freepose_tpu_torch.pipeline.tracking_refiner import _epnp_batch

K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
POSE_ATOL = 2e-5


def _scene(n=40, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    world = rng.uniform(-0.1, 0.1, size=(n, 3))
    r = Rot.random(random_state=rng).as_matrix()
    t = np.array([0.05, -0.03, 0.6])
    uv = (world @ r.T + t) @ K.T
    uv = uv[:, :2] / uv[:, 2:] + rng.normal(scale=noise, size=(n, 2))
    return world.astype(np.float32), uv.astype(np.float32)


def _mask(kind, n=40, seed=0):
    m = np.ones(n, bool)
    if kind == "some":
        m[np.random.default_rng(seed).permutation(n)[: n // 3]] = False
    elif kind in ("4", "3", "none"):
        m[:] = False
        m[np.random.default_rng(seed).permutation(n)[: {"4": 4, "3": 3, "none": 0}[kind]]] = True
    return m


def _jax_epnp(w, uv, m):
    return np.asarray(jax_pnp.epnp(jnp.asarray(w), jnp.asarray(uv), jnp.asarray(K), jnp.asarray(m)))


def _epnp(w, uv, m):
    return pnp.epnp(torch.as_tensor(w), torch.as_tensor(uv), torch.as_tensor(K), torch.as_tensor(m)).numpy()


@pytest.mark.parametrize("noise", [0.0, 1.0])
@pytest.mark.parametrize("kind", ["all", "some"])
def test_epnp_matches_jax(noise, kind):
    w, uv = _scene(noise=noise, seed=int(noise) + 1)
    m = _mask(kind, seed=2)
    np.testing.assert_allclose(_epnp(w, uv, m), _jax_epnp(w, uv, m), atol=POSE_ATOL)


@pytest.mark.parametrize("kind", ["4", "3", "none"])
def test_epnp_few_points_is_a_finite_rotation(kind):
    w, uv = _scene(noise=1.0, seed=5)
    m = _mask(kind, seed=3)
    ours, ref = _epnp(w, uv, m), _jax_epnp(w, uv, m)
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(ours[:3, :3] @ ours[:3, :3].T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(ours[3], [0, 0, 0, 1])
    if kind == "none":  # no valid point: both fall back to the same pose
        np.testing.assert_allclose(ours, ref, atol=POSE_ATOL)


def test_epnp_batch_matches_jax():
    w, _ = _scene(seed=3)
    uvs, masks = [], []
    for s in range(4):
        _, uv = _scene(seed=3)
        rng = np.random.default_rng(s)
        uvs.append(uv + rng.normal(scale=0.5, size=uv.shape).astype(np.float32))
        masks.append(_mask("some", seed=s))
    uv_t, m_t = np.stack(uvs), np.stack(masks)
    ours = _epnp_batch(torch.as_tensor(w), torch.as_tensor(uv_t), torch.as_tensor(K), torch.as_tensor(m_t)).numpy()
    ref = np.asarray(jax_epnp_batch(jnp.asarray(w), jnp.asarray(uv_t), jnp.asarray(K), jnp.asarray(m_t)))
    assert ours.shape == (4, 4, 4)
    np.testing.assert_allclose(ours, ref, atol=POSE_ATOL)


@pytest.mark.parametrize("kind", ["all", "some", "4"])
def test_kabsch_and_reprojection_error_match_jax(kind):
    rng = np.random.default_rng(7)
    src = rng.normal(size=(30, 3)).astype(np.float32)
    r = Rot.random(random_state=rng).as_matrix()
    dst = (src @ r.T + [0.1, -0.2, 0.7] + rng.normal(scale=0.01, size=(30, 3))).astype(np.float32)
    m = _mask(kind, n=30, seed=1)
    r_ours, t_ours = pnp._kabsch(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(m, dtype=torch.float32))
    r_ref, t_ref = jax_pnp._kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(m, jnp.float32))
    np.testing.assert_allclose(r_ours.numpy(), np.asarray(r_ref), atol=1e-5)
    np.testing.assert_allclose(t_ours.numpy(), np.asarray(t_ref), atol=1e-5)

    w, uv = _scene(n=30, noise=1.0, seed=4)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = Rot.from_rotvec([0.1, 0.2, 0.3]).as_matrix(), [0.05, -0.03, 0.6]
    ours = pnp.reprojection_error(torch.as_tensor(pose), torch.as_tensor(w), torch.as_tensor(uv), torch.as_tensor(K),
                                  torch.as_tensor(m))
    ref = jax_pnp.reprojection_error(jnp.asarray(pose), jnp.asarray(w), jnp.asarray(uv), jnp.asarray(K),
                                     jnp.asarray(m))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def _track(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rv = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), axis=0)
    poses[:, :3, :3] = Rot.from_rotvec(rv).as_matrix()
    poses[:, :3, 3] = np.cumsum(rng.normal(scale=0.02, size=(n, 3)), axis=0) + [0, 0, 1.0]
    return poses


@pytest.mark.parametrize("n", [1, 3, 12, 130])
def test_smooth_transforms_matches_jax(n):
    poses = _track(n, seed=n)
    ours = se3.smooth_transforms(torch.as_tensor(poses)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_se3.smooth_transforms(jnp.asarray(poses))), atol=1e-5)
    np.testing.assert_allclose(ours[:, :3, :3] @ ours[:, :3, :3].transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (n, 3, 3)), atol=1e-5)


def test_rotation_and_se3_helpers_match_jax():
    poses = _track(16, seed=9)
    r = poses[:, :3, :3]
    # Quaternions match up to sign (q and -q are one rotation).
    q_ours, q_ref = matrix_to_quat(torch.as_tensor(r)).numpy(), np.asarray(jax_matrix_to_quat(jnp.asarray(r)))
    np.testing.assert_allclose(q_ours * np.sign((q_ours * q_ref).sum(-1, keepdims=True)), q_ref, atol=1e-6)
    np.testing.assert_allclose(matrix_to_rotvec(torch.as_tensor(r)).numpy(),
                               np.asarray(jax_matrix_to_rotvec(jnp.asarray(r))), atol=1e-5)
    np.testing.assert_allclose(se3.so3_exp(se3.so3_log(torch.as_tensor(r))).numpy(), r, atol=1e-5)
    w = np.random.default_rng(1).random(16).astype(np.float32)
    a, b = average_quaternions(torch.as_tensor(q_ref), torch.as_tensor(w)).numpy(), np.asarray(
        jax_average_quaternions(jnp.asarray(q_ref), jnp.asarray(w)))
    np.testing.assert_allclose(a * np.sign(a @ b), b, atol=1e-5)
    np.testing.assert_allclose(se3.se3_inverse(torch.as_tensor(poses)).numpy(),
                               np.asarray(jax_se3.se3_inverse(jnp.asarray(poses))), atol=1e-6)
    np.testing.assert_allclose(se3.make_se3(torch.as_tensor(r), torch.as_tensor(poses[:, :3, 3])).numpy(), poses)


def test_update_k_with_crop_and_crop_bbox_match_jax():
    rng = np.random.default_rng(2)
    poses = _track(5, seed=2)
    poses[:, :3, 3] += [0.0, 0.0, 0.5]
    points = rng.uniform(-0.1, 0.1, size=(100, 3)).astype(np.float32)
    ours = camera.crop_bbox_around_projection(torch.as_tensor(poses), torch.as_tensor(points), torch.as_tensor(K),
                                              518, 518, lamb=1.4)
    ref = np.asarray(jax_camera.crop_bbox_around_projection(jnp.asarray(poses), jnp.asarray(points), jnp.asarray(K),
                                                            518, 518, lamb=1.4))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    ks = camera.update_k_with_crop(torch.as_tensor(K), torch.as_tensor(ref), 518, 518).numpy()
    np.testing.assert_allclose(ks, np.asarray(jax_camera.update_k_with_crop(jnp.asarray(K), jnp.asarray(ref), 518, 518)),
                               atol=1e-4)
    cam = (points + np.float32([0, 0, 1.0]))[None]
    np.testing.assert_allclose(camera.project_points(torch.as_tensor(cam), torch.as_tensor(K)).numpy(),
                               np.asarray(jax_camera.project_points(jnp.asarray(cam), jnp.asarray(K))), atol=1e-4)
