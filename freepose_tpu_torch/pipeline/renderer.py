"""High-level template renderer: batched render + proposal extraction.

Counterpart of freepose_tpu.pipeline.renderer: the reference camera model
(f=600 at 420×420, cx=cy=res/2) and the super-Fibonacci pose grid at z=1.1,
rendered in pose chunks by the tile rasterizer (K1 on the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.geometry.rotation import template_poses
from freepose_tpu_torch.io.mesh import TriMesh, pad_mesh
from freepose_tpu_torch.ops.rasterizer import RasterSettings, render_meshes

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
    # "auto": per-pixel texture sampling when the mesh carries an atlas (not
    # ported yet: raises); "bake": always shade baked vertex colours.
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
        return tuple(torch.as_tensor(a, device=self.device) for a in (v * scale, c, f, valid))

    def render(self, mesh: TriMesh, scale: float = RENDERING_SCALE):
        """Render the full template grid -> (rgb [N,R,R,3], depth [N,R,R])."""
        return self.render_from_poses(mesh, self.poses, scale=scale)

    def render_from_poses(self, mesh: TriMesh, poses: torch.Tensor, scale: float = RENDERING_SCALE):
        if self.texture_mode == "auto" and mesh.texture is not None and mesh.uv is not None:
            raise NotImplementedError(
                "textured template renders (texture_mode='auto' on a textured mesh) are not "
                "ported yet (ROADMAP queue 1, item 18: ops/texture.py); use texture_mode='bake'"
            )
        v, c, f, valid = self._padded(mesh, scale)
        return render_meshes(v, c, f, valid, poses.to(self.device), self.k, self.settings,
                             pose_chunk=self.pose_chunk)

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
