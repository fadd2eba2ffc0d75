"""BOP pose errors of the PyTorch port against the JAX package, on the CPU.

Every error function on the same seeded numpy points (a few hundred) and
poses: within 1e-6 relative, except chamfer_proj. There the expansion trick
x² + y² − 2·x·yᵀ cancels at pixel scale (coordinates ~300 px), so one ulp of
a projected point moves a few-pixel distance by ~1e-3 of itself; the JAX
package's eager 3x3 products round otherwise than torch.matmul, and the two
agree to 1e-4 relative, each as close to a float64 reference. The
MaskRenderer's "device" backend (the plain rasterizer on the CPU) against
the JAX one at 64x48 (masks identical, depth within 1e-5); the port's native
C++ renderer against the JAX package's, bit for bit (the same source and
flags); cus, vsd (a tau sweep, step and tlinear costs) and cou_bb_proj on
both backends; the analytic-sphere oracle of tests/test_cus_convention.py;
and a native build that fails must raise.
"""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from freepose_tpu.evaluation import pose_error as jpe
from freepose_tpu.io.mesh import TriMesh as JaxTriMesh
from freepose_tpu_torch.evaluation import pose_error as tpe
from freepose_tpu_torch.io.mesh import TriMesh
from freepose_tpu_torch.ops import raster_native

CPU = "cpu"
K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])
REL = 1e-6
CHAMFER_PROJ_REL = 1e-4


def _pose(seed, z=0.8):
    rng = np.random.default_rng(seed)
    return Rotation.random(random_state=seed).as_matrix(), np.array([*rng.uniform(-0.05, 0.05, 2), z])


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(300, 3)) * 0.06).astype(np.float32), (rng.normal(size=(260, 3)) * 0.06).astype(np.float32)


SYMS = [{"R": np.eye(3), "t": np.zeros(3)},
        {"R": Rotation.from_euler("z", 180, degrees=True).as_matrix(), "t": np.array([0.0, 0.0, 0.002])},
        {"R": Rotation.from_euler("x", 90, degrees=True).as_matrix(), "t": np.zeros(3)}]


def _cases(pa, pb, r1, t1, r2, t2):
    return {
        "chamfer": (lambda m, **d: m.chamfer(r1, t1, r2, t2, pa, pb, **d)),
        "add": (lambda m, **d: m.add(r1, t1, r2, t2, pa, **d)),
        "adi": (lambda m, **d: m.adi(r1, t1, r2, t2, pa, **d)),
        "proj": (lambda m, **d: m.proj(r1, t1, r2, t2, K, pa, **d)),
        "mssd": (lambda m, **d: m.mssd(r1, t1, r2, t2, pa, pa, **d)),
        "mssd_syms": (lambda m, **d: m.mssd(r1, t1, r2, t2, pa, pa, syms=SYMS, **d)),
        "mspd": (lambda m, **d: m.mspd(r1, t1, r2, t2, K, pa, pa, **d)),
        "mspd_syms": (lambda m, **d: m.mspd(r1, t1, r2, t2, K, pa, pa, syms=SYMS, **d)),
        "cou_bb": (lambda m, **d: m.cou_bb([12.0, 20.0, 130.0, 95.0], [30.0, 14.0, 118.0, 120.0], **d)),
    }


@pytest.mark.parametrize("name", ["chamfer", "add", "adi", "proj", "mssd", "mssd_syms", "mspd", "mspd_syms",
                                  "cou_bb"])
@pytest.mark.parametrize("seed", [1, 2])
def test_point_errors_match_jax(points, name, seed):
    (r1, t1), (r2, t2) = _pose(seed), _pose(seed + 10, z=0.85)
    fn = _cases(*points, r1, t1, r2, t2)[name]
    ref, ours = fn(jpe), fn(tpe, device=CPU)
    assert isinstance(ours, float)
    assert abs(ours - ref) <= REL * abs(ref), (name, ours, ref)


def _chamfer_proj_f64(r1, t1, r2, t2, pa, pb):
    def project(p, r, t):
        uvw = (p.astype(np.float64) @ r.T + t) @ K.T
        return uvw[:, :2] / uvw[:, 2:3]

    a, b = project(pa, r1, t1), project(pb, r2, t2)
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    return d.min(1).mean() + d.min(0).mean()


@pytest.mark.parametrize("seed", [1, 2])
def test_chamfer_proj_matches_jax(points, seed):
    (r1, t1), (r2, t2) = _pose(seed), _pose(seed + 10, z=0.85)
    pa, pb = points
    ref = jpe.chamfer_proj(r1, t1, r2, t2, K, pa, pb)
    ours = tpe.chamfer_proj(r1, t1, r2, t2, K, pa, pb, device=CPU)
    exact = _chamfer_proj_f64(r1, t1, r2, t2, pa, pb)
    assert abs(ours - ref) <= CHAMFER_PROJ_REL * ref
    assert abs(ours - exact) <= CHAMFER_PROJ_REL * exact and abs(ref - exact) <= CHAMFER_PROJ_REL * exact


def test_chamfer_blocks_give_the_same_value(points, monkeypatch):
    """Cutting the [N, M] distances into row blocks changes no value."""
    (r1, t1), (r2, t2) = _pose(3), _pose(13)
    pa, pb = points
    whole = tpe.chamfer(r1, t1, r2, t2, pa, pb, device=CPU), tpe.adi(r1, t1, r2, t2, pa, device=CPU)
    monkeypatch.setattr(tpe, "CHAMFER_ROWS", 7)
    assert (tpe.chamfer(r1, t1, r2, t2, pa, pb, device=CPU), tpe.adi(r1, t1, r2, t2, pa, device=CPU)) == whole


def test_re_te_and_cou_mask_match_jax():
    (r1, t1), (r2, t2) = _pose(4), _pose(5)
    assert tpe.re(r1, r2) == jpe.re(r1, r2) and tpe.te(t1, t2) == jpe.te(t1, t2)
    rng = np.random.default_rng(4)
    a, b = rng.random((48, 64)) > 0.6, rng.random((48, 64)) > 0.5
    assert tpe.cou_mask(a, b, device=CPU) == jpe.cou_mask(a, b)
    empty = np.zeros((4, 4), bool)
    assert tpe.cou_mask(empty, empty, device=CPU) == jpe.cou_mask(empty, empty) == 1.0


# --------------------------------------------------------------- renderer

W, H = 64, 48
K_SMALL = np.array([[70.0, 0.0, 31.3], [0.0, 70.0, 23.6], [0.0, 0.0, 1.0]])


def _blob(n_lat=10, n_lon=14, seed=0):
    """A bumpy sphere of 280 faces, radius ~0.4: numpy arrays."""
    rng = np.random.default_rng(seed)
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 0.4 + 0.1 * np.sin(3 * ph) * np.sin(th)
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    v = np.asarray(verts, np.float32)
    return v, np.asarray(faces, np.int32), rng.random((len(v), 3)).astype(np.float32)


def _renderers(backend):
    v, f, c = _blob()
    ours = tpe.MaskRenderer(W, H, backend=backend, device=CPU)
    ref = jpe.MaskRenderer(W, H, backend=backend)
    assert ref.backend == backend and ours.backend == backend
    for obj, scale in (("a", 1.0), ("b", 0.8)):
        ours.add_object(obj, TriMesh(v * scale, f, c))
        ref.add_object(obj, JaxTriMesh(v * scale, f, c))
    return ours, ref


POSES = [(_pose(s, z=2.2)[0], np.array([0.05 * s - 0.1, 0.03, 2.2 + 0.1 * s])) for s in range(3)]


@pytest.mark.parametrize("backend", ["device", "native"])
def test_mask_renderer_matches_jax(backend):
    ours, ref = _renderers(backend)
    for r, t in POSES:
        for scale in (1.0, 0.7):
            d_ours = ours.render_depth("a", r, t, K_SMALL, scale=scale)
            d_ref = np.asarray(ref.render_depth("a", r, t, K_SMALL, scale=scale))
            assert d_ours.shape == (H, W) and d_ours.dtype == torch.float32
            d_ours = d_ours.numpy()
            assert (d_ref > 0).sum() > 100
            assert np.array_equal(d_ours > 0, d_ref > 0)
            if backend == "native":  # the same C++ source and flags
                assert np.array_equal(d_ours, d_ref)
            else:
                np.testing.assert_allclose(d_ours, d_ref, atol=1e-5, rtol=0)


def test_auto_picks_native_on_the_cpu():
    assert tpe.MaskRenderer(W, H, device=CPU).backend == "native"
    with pytest.raises(ValueError):
        tpe.MaskRenderer(W, H, backend="xla", device=CPU)


def _scene_depth(renderer, r, t):
    """A test depth image: the GT render plus a plane behind it, with a
    strip of the object occluded by a nearer box and a hole of no reading."""
    d = np.asarray(renderer.render_depth("b", r, t, K_SMALL), np.float32)
    scene = np.where(d > 0, d, np.float32(3.0))
    scene[:, 40:46] = np.minimum(scene[:, 40:46], 1.5)
    scene[10:14, 20:30] = 0.0
    return scene


@pytest.mark.parametrize("backend", ["device", "native"])
def test_cus_vsd_and_cou_bb_proj_match_jax(backend):
    ours, ref = _renderers(backend)
    (r_gt, t_gt), (r_est, t_est) = POSES[0], POSES[1]
    taus = tuple(np.round(np.arange(0.05, 0.51, 0.05), 2))
    depth_test = _scene_depth(ref, r_gt, t_gt)
    for est_scale in (1.0, 1.2):
        for r, t in ((r_est, t_est), (r_gt, t_gt + np.array([0.02, 0.0, 0.0]))):
            c_ours = tpe.cus(r, t, r_gt, t_gt, K_SMALL, ours, "a", "b", est_scale=est_scale)
            c_ref = jpe.cus(r, t, r_gt, t_gt, K_SMALL, ref, "a", "b", est_scale=est_scale)
            assert c_ours == c_ref and 0.0 < c_ref < 1.0
            for cost in ("step", "tlinear"):
                args = (r, t, r_gt, t_gt, depth_test, K_SMALL, 0.015, taus, True, 0.9)
                v_ours = tpe.vsd(*args, ours, "a", "b", cost_type=cost, est_scale=est_scale)
                v_ref = jpe.vsd(*args, ref, "a", "b", cost_type=cost, est_scale=est_scale)
                assert len(v_ours) == len(taus)
                np.testing.assert_allclose(v_ours, v_ref, rtol=REL, atol=0)
                assert 0.0 < min(v_ref) < 1.0
    assert tpe.cou_bb_proj(r_est, t_est, r_gt, t_gt, K_SMALL, ours, "a") == \
        jpe.cou_bb_proj(r_est, t_est, r_gt, t_gt, K_SMALL, ref, "a")
    behind = np.array([0.0, 0.0, -2.0])  # an empty render scores 1.0
    assert tpe.cou_bb_proj(r_est, behind, r_gt, t_gt, K_SMALL, ours, "a") == 1.0


def test_vsd_errors_of_empty_renders_are_one():
    z = torch.zeros((H, W))
    errs = tpe.vsd_errors(z + 1.0, z, z, torch.as_tensor(K_SMALL, dtype=torch.float32), 0.015, 1.0, [0.1, 0.2],
                          "step", True)
    assert errs.tolist() == [1.0, 1.0]
    with pytest.raises(ValueError):
        tpe.vsd_errors(z, z, z, torch.as_tensor(K_SMALL, dtype=torch.float32), 0.015, 1.0, [0.1], "nope", True)


# ------------------------------------------- the analytic-sphere oracle (copied)

OW, OH = 160, 120
OK = np.array([[150.0, 0, 83.0], [0, 150.0, 57.0], [0, 0, 1]], np.float32)
RHO = 0.3
CENTER = np.array([0.12, -0.06, 1.2], np.float32)


def _sphere_mesh(n=80, radius=RHO):
    verts, faces = [], []
    for i in range(n + 1):
        th = np.pi * i / n
        for j in range(n):
            ph = 2 * np.pi * j / n
            verts.append([radius * np.sin(th) * np.cos(ph), radius * np.sin(th) * np.sin(ph), radius * np.cos(th)])
    for i in range(n):
        for j in range(n):
            a, b = i * n + j, i * n + (j + 1) % n
            c, d = (i + 1) * n + j, (i + 1) * n + (j + 1) % n
            faces += [[a, b, c], [b, d, c]]
    v = np.asarray(verts, np.float32)
    return TriMesh(v, np.asarray(faces, np.int32), np.full((len(v), 3), 0.7, np.float32))


def _analytic_sphere_mask(center, radius=RHO, du=0.0, dv=0.0):
    """[H, W] bool: the ray through pixel centre (i+0.5+du, j+0.5+dv) passes
    within `radius` of `center` (in front of the camera)."""
    uu, vv = np.meshgrid(np.arange(OW) + 0.5 + du, np.arange(OH) + 0.5 + dv)
    d = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ np.linalg.inv(OK).T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.asarray(center, np.float64)
    along = d @ c
    return (np.sum(c * c) - along**2 <= radius * radius) & (along > 0)


def _certain_masks(center, eps_px=0.2):
    """(inside, outside): pixels whose analytic class holds under ±eps_px
    shifts of the pixel centre; a half-pixel convention error flips a
    boundary band of them."""
    evals = [_analytic_sphere_mask(center, du=du, dv=dv)
             for du, dv in [(0, 0), (eps_px, 0), (-eps_px, 0), (0, eps_px), (0, -eps_px)]]
    return np.logical_and.reduce(evals), np.logical_and.reduce([~e for e in evals])


@pytest.fixture(scope="module")
def sphere():
    return _sphere_mesh()


@pytest.mark.parametrize("backend", ["device", "native"])
def test_mask_renderer_matches_analytic_sphere(backend, sphere):
    r = tpe.MaskRenderer(OW, OH, backend=backend, max_faces_per_tile=4096, device=CPU)
    r.add_object("sph", sphere)
    mask = (r.render_depth("sph", np.eye(3, dtype=np.float32), CENTER, OK) > 0).numpy()
    cin, cout = _certain_masks(CENTER)
    assert cin.sum() > 1000 and cout.sum() > 1000
    assert int((cin & ~mask).sum()) == 0, f"{backend}: certain-inside pixels unlit"
    assert int((cout & mask).sum()) == 0, f"{backend}: certain-outside pixels lit"


def test_oracle_detects_half_pixel_shift():
    shifted = _analytic_sphere_mask(CENTER, du=-0.5, dv=-0.5)
    cin, cout = _certain_masks(CENTER)
    assert int((cin & ~shifted).sum() + (cout & shifted).sum()) > 20


def test_cus_matches_analytic_cou(sphere):
    r = tpe.MaskRenderer(OW, OH, backend="native", device=CPU)
    r.add_object("est", sphere)
    r.add_object("gt", sphere)
    c_est = CENTER + np.array([0.06, 0.03, 0.0], np.float32)
    e = tpe.cus(np.eye(3, dtype=np.float32), c_est, np.eye(3, dtype=np.float32), CENTER, OK, r, "est", "gt")
    m_est, m_gt = _analytic_sphere_mask(c_est), _analytic_sphere_mask(CENTER)
    expected = 1.0 - (m_est & m_gt).sum() / float((m_est | m_gt).sum())
    assert 0.05 < expected < 0.95
    assert abs(e - expected) < 0.01, (e, expected)


# ------------------------------------------------------------- native build

def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "raster_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(raster_native, "SOURCE", bad)
    monkeypatch.setattr(raster_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        raster_native.rasterize_native(np.zeros((3, 3), np.float32), np.zeros((1, 3), np.int32),
                                       np.eye(4, dtype=np.float32)[None], OK, height=8)
    r = tpe.MaskRenderer(8, 8, backend="native", device=CPU)
    r.add_object("x", TriMesh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]], np.int32)))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        r.render_depth("x", np.eye(3), np.array([0, 0, 2.0]), OK)


def test_native_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    src = tmp_path / "a.cpp"
    src.write_text(raster_native.SOURCE.read_text())
    first = raster_native.library_path(src)
    src.write_text(src.read_text() + "\n// edited\n")
    assert raster_native.library_path(src) != first
