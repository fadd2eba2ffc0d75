"""Seeded inputs of the video cells, made by the benchmark: the mesh, the
object's trajectory and the videos. The same seed gives the same inputs;
every seed gives videos of the same sizes and lengths."""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from benchmark.reference.frozen.rasterizer import RasterSettings, render_meshes
from benchmark.reference.frozen.rotation import quat_to_matrix

RENDER_Z = 1.1  # the template camera's distance (the renderer's pose grid)
RENDER_SCALE = 0.25  # meshes render at quarter scale, as every template


def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:7], "little")


def bumpy_torus(seed: int, n_u: int = 128, n_v: int = 64):
    """A coloured torus of n_u·n_v vertices and 2·n_u·n_v faces (8,192 and
    16,384 by default: the renderer's budget), its minor radius modulated by
    seeded harmonics, centred, at unit half-extent -> (vertices [V, 3],
    faces [F, 3] int32, colours [V, 3]) float32 numpy."""
    rng = np.random.default_rng(sub_seed(seed, "mesh"))
    u = 2 * np.pi * np.arange(n_u) / n_u
    v = 2 * np.pi * np.arange(n_v) / n_v
    uu, vv = np.meshgrid(u, v, indexing="ij")
    bump = sum(rng.uniform(0.03, 0.08) * np.sin(a * uu + b * vv + rng.uniform(0, 2 * np.pi))
               for a, b in rng.integers(1, 6, size=(4, 2)))
    r = 0.35 * (1.0 + bump)
    verts = np.stack([(1.0 + r * np.cos(vv)) * np.cos(uu), (1.0 + r * np.cos(vv)) * np.sin(uu),
                      0.6 * r * np.sin(vv)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a, b = i * n_v + j, ((i + 1) % n_u) * n_v + j
    c, d = i * n_v + (j + 1) % n_v, ((i + 1) % n_u) * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 0).reshape(-1, 3)
    colors = np.clip(0.5 + 0.5 * np.sin(verts @ rng.normal(size=(3, 3)) * 3.0), 0, 1)
    lo, hi = verts.min(0), verts.max(0)
    verts = (verts - (lo + hi) / 2) / ((hi - lo).max() / 2)
    return verts.astype(np.float32), faces.astype(np.int32), colors.astype(np.float32)


def _axis_angle(axis: np.ndarray, deg: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    th = math.radians(deg)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(th) * k + (1 - math.cos(th)) * (k @ k)


def trajectory(seed: int, n: int, deg_per_frame: float) -> np.ndarray:
    """[n, 4, 4] object poses at the template distance: a seeded start
    rotation turned `deg_per_frame` each frame about an axis that wobbles
    around a seeded direction."""
    rng = np.random.default_rng(sub_seed(seed, "trajectory"))
    q = rng.normal(size=4)
    rot = quat_to_matrix(torch.as_tensor(q / np.linalg.norm(q), dtype=torch.float64)).numpy()
    a0, b0 = rng.normal(size=3), rng.normal(size=3)
    phase = rng.uniform(0, 2 * np.pi)
    poses = np.zeros((n, 4, 4))
    for k in range(n):
        poses[k, :3, :3] = rot
        poses[k, :3, 3] = (0.0, 0.0, RENDER_Z)
        poses[k, 3, 3] = 1.0
        axis = a0 / np.linalg.norm(a0) + 0.35 * math.sin(2 * math.pi * k / 64 + phase) * b0 / np.linalg.norm(b0)
        rot = _axis_angle(axis, deg_per_frame) @ rot
    return poses.astype(np.float32)


def render_sprites(mesh, poses: np.ndarray, res: int, device, chunk: int = 32):
    """The mesh at `poses` in a res² camera that frames it -> (rgb [n, res,
    res, 3] float, mask [n, res, res] bool), through the reference's plain
    rasterizer."""
    verts, faces, colors = (torch.as_tensor(a, device=device) for a in mesh)
    f = 600.0 * res / 420.0
    k = torch.tensor([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1]], dtype=torch.float32, device=device)
    valid = torch.ones(faces.shape[0], dtype=torch.bool, device=device)
    settings = RasterSettings(resolution=res, tile=32, max_faces_per_tile=256)
    rgb, depth = render_meshes(verts * RENDER_SCALE, colors, faces, valid, torch.as_tensor(poses, device=device), k,
                               settings, pose_chunk=chunk)
    return rgb, depth > 0


def make_videos(seed: int, mesh, n_videos: int, frames: int, hw: tuple[int, int], object_res: int,
                deg_per_frame: float, device):
    """`n_videos` videos of `frames` frames at hw = (H, W): noise over
    seeded low-frequency blocks, the mesh's sprite (one trajectory of
    2·frames poses; video v starts at a seeded offset of it) drifting along
    a seeded path. Returns a list of dicts: frames [T, H, W, 3] uint8 numpy
    (host), mask [T, H, W] bool (device: the object's pixels), box0 [4]
    xyxy (frame 0's object box)."""
    h, w = hw
    traj = trajectory(seed, 2 * frames, deg_per_frame)
    sprite_rgb, sprite_mask = render_sprites(mesh, traj, object_res, device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "videos") % (2**62))
    rng = np.random.default_rng(sub_seed(seed, "paths"))
    videos = []
    for _ in range(n_videos):
        start = int(rng.integers(0, frames))
        blocks = torch.rand((3, 9, 16), generator=gen, device=device) * 120
        bg = torch.nn.functional.interpolate(blocks[None], size=(h, w), mode="nearest")[0].permute(1, 2, 0)
        x0, x1 = rng.uniform(0.1, 0.9, size=2) * (w - object_res)
        y_mid, y_amp = rng.uniform(0.3, 0.7) * (h - object_res), rng.uniform(0, 0.2) * (h - object_res)
        out = torch.empty((frames, h, w, 3), dtype=torch.uint8, device=device)
        mask = torch.zeros((frames, h, w), dtype=torch.bool, device=device)
        for t in range(frames):
            s = t / max(frames - 1, 1)
            x = int(round(x0 + (x1 - x0) * s))
            y = int(round(np.clip(y_mid + y_amp * math.sin(2 * math.pi * s), 0, h - object_res)))
            img = bg + torch.rand((h, w, 3), generator=gen, device=device) * 30
            m = sprite_mask[start + t]
            patch = img[y:y + object_res, x:x + object_res]
            img[y:y + object_res, x:x + object_res] = torch.where(m[..., None], sprite_rgb[start + t] * 255, patch)
            mask[t, y:y + object_res, x:x + object_res] = m
            out[t] = img.clamp(0, 255).to(torch.uint8)
        ys, xs = torch.nonzero(mask[0], as_tuple=True)
        box0 = np.array([xs.min().item(), ys.min().item(), xs.max().item() + 1, ys.max().item() + 1], np.float32)
        videos.append({"frames": out.cpu().numpy(), "mask": mask, "box0": box0})
    return videos

