"""High-level template renderer: batched render + proposal extraction.

Counterpart of freepose_tpu.pipeline.renderer: the reference camera model
(f=600 at 420×420, cx=cy=res/2) and the super-Fibonacci pose grid at z=1.1,
rendered in pose chunks by the tile rasterizer (K1 on the card); a mesh with
a texture atlas is sampled per pixel (ops/texture.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.geometry.rotation import template_poses
from freepose_tpu_torch.io.mesh import TriMesh, fit_to_budget, pad_mesh, pad_uv
from freepose_tpu_torch.ops.rasterizer import RasterSettings, camera_points, render_meshes
from freepose_tpu_torch.ops.texture import render_textured
from freepose_tpu_torch.utils import timing

TEMPLATE_FOCAL = 600.0
TEMPLATE_RES = 420
TEMPLATE_Z = 1.1
RENDERING_SCALE = 0.25  # meshes rendered at quarter scale
DEGENERATE_MASK_MIN_PX = 100  # fallback threshold for near-empty renders


def template_intrinsics(res: int = TEMPLATE_RES, f: float = TEMPLATE_FOCAL,
                        device: str | torch.device | None = None) -> torch.Tensor:
    return torch.tensor([[f, 0.0, res / 2], [0.0, f, res / 2], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


@dataclasses.dataclass
class TemplateRenderer:
    """Renders a mesh from the n-pose super-Fibonacci grid (or arbitrary
    poses) and extracts square proposals, on `device` ("cuda" unless the
    caller asks for the CPU)."""

    n_poses: int = 600
    resolution: int = TEMPLATE_RES
    max_vertices: int = 8192
    max_faces: int = 16384
    pose_chunk: int = 128
    settings: RasterSettings | None = None
    # "auto": per-pixel texture sampling when the mesh carries an atlas;
    # "bake": always shade baked vertex colours.
    texture_mode: str = "auto"
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.settings is None:
            self.settings = RasterSettings(resolution=self.resolution)
        self.poses = template_poses(self.n_poses, z=TEMPLATE_Z, device=self.device)
        # Focal length scales with resolution so any res keeps the reference FOV.
        f = TEMPLATE_FOCAL * self.resolution / TEMPLATE_RES
        self.k = template_intrinsics(self.resolution, f, device=self.device)

    def _padded(self, mesh: TriMesh, scale: float):
        v, c, f, valid = pad_mesh(mesh, self.max_vertices, self.max_faces)
        with timing.wait("renderer.mesh"):  # uploads from pageable memory synchronise
            return tuple(torch.as_tensor(a, device=self.device) for a in (v * scale, c, f, valid))

    def render(self, mesh: TriMesh, scale: float = RENDERING_SCALE):
        """Render the full template grid -> (rgb [N,R,R,3], depth [N,R,R])."""
        return self.render_from_poses(mesh, self.poses, scale=scale)

    def render_from_poses(self, mesh: TriMesh, poses: torch.Tensor, scale: float = RENDERING_SCALE):
        """Textured meshes sample their atlas per pixel (ops/texture.py, the
        reference's GL textured render) when texture_mode is "auto"; "bake"
        forces the per-vertex-colour fallback."""
        poses = poses.to(self.device)
        if self.texture_mode == "auto" and mesh.texture is not None and mesh.uv is not None:
            fitted = fit_to_budget(mesh, self.max_vertices, self.max_faces)
            v, _, f, valid = self._padded(fitted, scale)
            uvw = torch.as_tensor(pad_uv(fitted, self.max_vertices), device=self.device)
            texture = torch.as_tensor(fitted.texture, device=self.device)
            return render_textured(v, uvw, f, valid, poses, self.k, texture, self.settings,
                                   pose_chunk=self.pose_chunk)
        v, c, f, valid = self._padded(mesh, scale)
        return render_meshes(v, c, f, valid, poses, self.k, self.settings, pose_chunk=self.pose_chunk)

    def generate_proposals(self, rgb: torch.Tensor, depth: torch.Tensor, target: int | None = None):
        """Crop each render around its mask bbox -> (proposals [N, 3, target,
        target], masks [N, R, R] bool, boxes [N, 4] xyxy)."""
        target = target or self.resolution
        return generate_proposals(rgb, depth, target, self.resolution)


def generate_proposals(rgb: torch.Tensor, depth: torch.Tensor, target: int, res: int):
    masks = depth > 0
    # Degenerate-mask fallback: a centred res/2 square.
    q = res // 4
    fallback = torch.zeros((res, res), dtype=torch.bool, device=depth.device)
    fallback[q : res - q, q : res - q] = True
    small = masks.sum(dim=(1, 2)) < DEGENERATE_MASK_MIN_PX
    masks = torch.where(small[:, None, None], fallback[None], masks)
    boxes = mask_to_bbox(masks)
    props = crop_resize_pad(rgb.permute(0, 3, 1, 2), boxes, target)
    return props, masks, boxes


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32 (exact float64 product and sum): the
    fused multiply-add that XLA's CPU backend forms where the JAX function
    writes x / z · f + c and res - b·s, so the zoomed intrinsics agree with
    it bit for bit (tests/test_torch_online_estimator.py)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    return (a.double() * torch.as_tensor(b, dtype=torch.float32, device=a.device).double()
            + torch.as_tensor(c, dtype=torch.float32, device=a.device).double()).to(torch.float32)


def zoom_intrinsics_for_poses(
    v: torch.Tensor,  # [Vmax, 3] padded (pre-scaled) vertices
    f: torch.Tensor,  # [Fmax, 3] padded faces
    face_valid: torch.Tensor,  # [Fmax] bool
    poses: torch.Tensor,  # [P, 4, 4]
    k: torch.Tensor,  # [3, 3] base camera
    res: int,
) -> torch.Tensor:
    """Per-pose zoomed intrinsics [P, 3, 3]: map each pose's projected-vertex
    bbox onto the full res×res canvas with crop_resize_pad's convention
    (isotropic max-side scale, centred), so a render under k_zoom[p] is the
    proposal crop at native resolution. A silhouette's extremes are
    projected vertices, so the bbox needs no rasterization. A pose whose
    vertices all lie behind the camera keeps the unzoomed k.

    The vertices counted are those of the valid faces. (The JAX function
    marks them with one scatter of face_valid over all face corners; where
    a padding face names the same vertex, which write lands is left to the
    backend, and on the CPU the padding face's False does, so there vertex
    0 drops out of the bbox whenever the mesh is padded.)"""
    vmask = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
    vmask[f[face_valid].reshape(-1).long()] = True
    pc = camera_points(v, poses)  # [P, V, 3]
    z = pc[..., 2]
    ok = vmask & (z > 1e-6)
    zs = torch.clamp(z, min=1e-6)
    u = _fma(pc[..., 0] / zs, k[0, 0], k[0, 2])
    w = _fma(pc[..., 1] / zs, k[1, 1], k[1, 2])
    big = torch.tensor(1e9, dtype=torch.float32, device=v.device)
    x1 = torch.where(ok, u, big).amin(dim=1).clamp(0.0, res - 1.0)
    x2 = torch.where(ok, u, -big).amax(dim=1).clamp(0.0, res - 1.0)
    y1 = torch.where(ok, w, big).amin(dim=1).clamp(0.0, res - 1.0)
    y2 = torch.where(ok, w, -big).amax(dim=1).clamp(0.0, res - 1.0)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    # A tensor numerator: `res / t` would multiply by t's reciprocal.
    s = torch.full_like(bw, float(res)) / torch.maximum(bw, bh)
    pad_l = _fma(-bw, s, res) / 2.0
    pad_t = _fma(-bh, s, res) / 2.0
    kz = torch.zeros((poses.shape[0], 3, 3), dtype=torch.float32, device=v.device)
    kz[:, 0, 0] = k[0, 0] * s
    kz[:, 1, 1] = k[1, 1] * s
    kz[:, 0, 2] = (k[0, 2] - x1) * s + pad_l
    kz[:, 1, 2] = (k[1, 2] - y1) * s + pad_t
    kz[:, 2, 2] = 1.0
    return torch.where(ok.any(dim=1)[:, None, None], kz, k)


def render_template_views(
    mesh: TriMesh,
    n_poses: int = 600,
    resolution: int = TEMPLATE_RES,
    scale: float = RENDERING_SCALE,
    **kwargs,
) -> dict:
    """One-call template pack for a mesh: rgb/depth/masks/poses/intrinsics."""
    renderer = TemplateRenderer(n_poses=n_poses, resolution=resolution, **kwargs)
    rgb, depth = renderer.render(mesh, scale=scale)
    return {
        "rgb": rgb,
        "depth": depth,
        "poses": renderer.poses,
        "intrinsic": renderer.k,
        "masks": depth > 0,
    }


def encode_depth_png_mm(depth: np.ndarray) -> np.ndarray:
    """Metric depth [H, W] float -> uint16 millimetres (shard format)."""
    return np.clip(np.asarray(depth) * 1000.0, 0, 65535).astype(np.uint16)


def decode_depth_png_mm(depth_mm: np.ndarray) -> np.ndarray:
    return np.asarray(depth_mm).astype(np.float32) / 1000.0
