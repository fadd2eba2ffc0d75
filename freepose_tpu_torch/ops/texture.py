"""Texture-mapped rendering on top of the tile rasterizer.

Counterpart of freepose_tpu.ops.texture. The GL fragment stage of the
reference's textured render splits in two:

  1. UV pass: the rasterizer interpolates a per-vertex (u, v, w) attribute
     exactly like vertex colours (perspective-correct, ambient 1, so the
     clip to [0, 1] is a no-op), through K1 on the card and its plain
     version on the CPU. w carries "has a real vt reference"; any no-vt
     ancestry interpolates to w < 1 and falls back to the bake's grey.
  2. Texture lookup: one gather per tap over the final pixels only, from
     the flattened [Ht·Wt, 3] atlas (plain PyTorch; the JAX package's lookup
     is a plain XLA gather too, not a Pallas kernel).

Shading runs per pose chunk: at 600 views of 420² the bilinear taps alone,
[P, R, R, 4, 3] fp32, would take 5 GB.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freepose_tpu_torch.ops.rasterizer import RasterSettings, render_meshes

# Shade of a pixel whose face has no vt reference, before ambient shading:
# the grey the bake gives such vertices (io/mesh.py:load_obj).
NO_VT_GRAY = 0.7


def uv_to_texel(uv: torch.Tensor, th: int, tw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """OBJ UV ([0, 1], v up) -> continuous texel coordinates (x right, y
    down), the bake's convention (io/mesh.py:_bake_texture_to_vertices)."""
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (tw - 1)
    y = (1.0 - torch.clamp(uv[..., 1], 0.0, 1.0)) * (th - 1)
    return x, y


def sample_texture(uv: torch.Tensor, texture: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """Sample `texture` [Ht, Wt, 3] at `uv` [..., 2] -> [..., 3]: one row
    gather per tap from the flattened [Ht·Wt, 3] atlas, the taps of every
    pixel in one gather."""
    th, tw = texture.shape[:2]
    x, y = uv_to_texel(uv, th, tw)
    flat = texture.reshape(th * tw, 3)
    if method == "nearest":
        xi = torch.clamp(torch.round(x).long(), 0, tw - 1)
        yi = torch.clamp(torch.round(y).long(), 0, th - 1)
        return flat[(yi * tw + xi).reshape(-1)].reshape(*uv.shape[:-1], 3)
    if method != "bilinear":
        raise ValueError(f"unknown texture sampling {method!r}")
    x0 = torch.clamp(torch.floor(x).long(), 0, tw - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, th - 1)
    x1 = torch.clamp(x0 + 1, max=tw - 1)
    y1 = torch.clamp(y0 + 1, max=th - 1)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    idx = torch.stack([y0 * tw + x0, y0 * tw + x1, y1 * tw + x0, y1 * tw + x1], dim=-1)  # [..., 4]
    taps = flat[idx.reshape(-1)].reshape(*idx.shape, 3)  # [..., 4, 3]
    top = taps[..., 0, :] * (1 - fx) + taps[..., 1, :] * fx
    bot = taps[..., 2, :] * (1 - fx) + taps[..., 3, :] * fx
    return top * (1 - fy) + bot * fy


def shade_uv_image(uv_img: torch.Tensor, depth: torch.Tensor, texture: torch.Tensor, ambient: float,
                   method: str = "bilinear") -> tuple[torch.Tensor, torch.Tensor]:
    """UV image [P, R, R, 3] of interpolated (u, v, w) and depth [P, R, R]
    -> (rgb [P, R, R, 3], depth): the atlas sampled per pixel, ambient
    shading clipped to [0, 1], the bake's grey where w < 1, zero background."""
    hit = depth > 0
    rgb = torch.clamp(sample_texture(uv_img[..., :2], texture, method) * ambient, 0.0, 1.0)
    gray = float(np.clip(np.float32(NO_VT_GRAY) * np.float32(ambient), 0.0, 1.0))  # float32, as JAX rounds it
    rgb = torch.where(uv_img[..., 2:3] < 0.999, gray, rgb)
    return torch.where(hit[..., None], rgb, 0.0), depth


def render_textured(
    vertices: torch.Tensor,  # [V, 3]
    uvw: torch.Tensor,  # [V, 3]: (u, v, has_vt), the io/mesh.py pad_uv layout
    faces: torch.Tensor,  # [F, 3]
    face_valid: torch.Tensor,  # [F]
    poses: torch.Tensor,  # [P, 4, 4]
    k: torch.Tensor,  # [3, 3] or [P, 3, 3]
    texture: torch.Tensor,  # [Ht, Wt, 3] float32 in [0, 1]
    settings: RasterSettings,
    method: str = "bilinear",
    pose_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Textured render -> (rgb [P, R, R, 3], depth [P, R, R]), the contract
    of rasterizer.rasterize (ambient shading, zero background). The UV pass
    renders in chunks of `pose_chunk` poses and each chunk is shaded alone,
    which changes no pixel."""
    uv_settings = dataclasses.replace(settings, ambient=1.0, depth_only=False)
    uv_img, depth = render_meshes(vertices, uvw, faces, face_valid, poses, k, uv_settings, pose_chunk=pose_chunk)
    chunk = pose_chunk or poses.shape[0]
    rgb = torch.cat([shade_uv_image(uv_img[i : i + chunk], depth[i : i + chunk], texture, settings.ambient,
                                    method)[0] for i in range(0, poses.shape[0], chunk)])
    return rgb, depth
