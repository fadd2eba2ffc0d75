"""Tile rasterizer on Hopper: plain-PyTorch prologue + CUDA kernel K1.

Counterpart of freepose_tpu.ops.rasterizer_pallas. The prologue projects the
mesh for every pose (`project_faces`), bins faces into tiles with the shared
selection policy (`bin_faces`, ops/rasterizer.py:select_tile_faces) into
per-tile slot indices [P, T, M] int32 (-1 = no face), and writes one
attribute row per face (`face_rows`, [P, F, 32] f32). The kernel
(csrc/raster_tile.cu) gathers each tile's rows itself into shared memory and
shades every tile pixel, writing the [P, R, R, 4] image. The JAX prologue's
[P·T, 32, M] attribute pack, built for the TPU's BlockSpec, has no
counterpart here. The output is pixel-identical to the plain rasterizer:
same binning, same seam epsilon, same z-winner, same rounding (the kernel is
built without FMA contraction).

`raster_tile` is the kernel's wrapper: a CUDA tensor launches K1 (or
raises; counted as `launch.k1` while tracing is on, utils/timing.py), a CPU
tensor runs `raster_tile_plain`, the same arithmetic in PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from freepose_tpu_torch.ops.rasterizer import (
    RasterSettings,
    _project_vertices,
    _tile_origins,
    select_tile_faces,
    tiles_to_images,
)
from freepose_tpu_torch.utils import timing

# Face-row columns (N_ATTRS per face); csrc/raster_tile.cu uses the same
# order. Geometry rows first, colour last so depth_only can skip them.
_ROWS = dict(
    d0x=0, d0y=1, bx=2, by=3,          # edge 0: cross(c-b, p-b)
    d1x=4, d1y=5, cx=6, cy=7,          # edge 1: cross(a-c, p-c)
    d2x=8, d2y=9, ax=10, ay=11,        # edge 2: cross(b-a, p-a)
    iza=12, izb=13, izc=14,            # 1/z at vertices (pre-clamped)
    sgn=15, inv_area=16, eps=17, valid=18,
    c0r=19, c0g=20, c0b=21, c1r=22, c1g=23, c1b=24, c2r=25, c2g=26, c2b=27,
)
N_ATTRS = 32


def project_faces(vertices, faces, face_valid, poses, ks, settings: RasterSettings):
    """Screen positions tri_uv [P, F, 3, 2], camera depths tri_z [P, F, 3]
    and the faces binning may take, valid [P, F] (not padding, in front of
    znear), for P poses at once."""
    uv, z = _project_vertices(vertices, poses, ks)  # [P, V, 2], [P, V]
    faces = faces.long()
    tri_uv = uv[:, faces]
    tri_z = z[:, faces]
    return tri_uv, tri_z, face_valid & (tri_z > settings.znear).all(dim=-1)


def bin_faces(tri_uv, valid, settings: RasterSettings) -> torch.Tensor:
    """Each tile's candidate faces as slot indices [P, T, M] int32, M =
    min(max_faces_per_tile, F): `select_tile_faces`, with -1 where a slot
    holds no face."""
    grid = -(-settings.resolution // settings.tile)
    m = min(settings.max_faces_per_tile, tri_uv.shape[1])
    top_idx, sel_valid = select_tile_faces(
        tri_uv.amin(dim=2), tri_uv.amax(dim=2), valid, grid, settings.tile, m, settings.binning
    )
    return torch.where(sel_valid, top_idx, -1).to(torch.int32)


def face_rows(tri_uv, tri_z, colors, faces, settings: RasterSettings) -> torch.Tensor:
    """One attribute row per face and pose, [P, F, N_ATTRS] f32, in `_ROWS`
    order; the colour rows stay 0 for depth_only, rows 28-31 are 0."""
    p = tri_uv.shape[0]
    a, b, c = tri_uv[:, :, 0], tri_uv[:, :, 1], tri_uv[:, :, 2]  # [P, F, 2]
    area = (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (c[..., 0] - a[..., 0])
    nondegen = area.abs() > 1e-12
    iz = 1.0 / torch.clamp(tri_z, min=settings.znear)
    r = _ROWS
    assign = {
        r["d0x"]: c[..., 0] - b[..., 0], r["d0y"]: c[..., 1] - b[..., 1],
        r["bx"]: b[..., 0], r["by"]: b[..., 1],
        r["d1x"]: a[..., 0] - c[..., 0], r["d1y"]: a[..., 1] - c[..., 1],
        r["cx"]: c[..., 0], r["cy"]: c[..., 1],
        r["d2x"]: b[..., 0] - a[..., 0], r["d2y"]: b[..., 1] - a[..., 1],
        r["ax"]: a[..., 0], r["ay"]: a[..., 1],
        r["iza"]: iz[..., 0], r["izb"]: iz[..., 1], r["izc"]: iz[..., 2],
        r["sgn"]: torch.sign(area),
        r["inv_area"]: torch.where(nondegen, 1.0 / area, torch.zeros_like(area)),
        r["eps"]: 1e-5 * area.abs(),
        r["valid"]: nondegen.to(torch.float32),  # a slot of -1 reads as 0
    }
    if not settings.depth_only:
        cols = colors[faces.long()]  # [F, 3 vertices, 3 channels]
        for vi in range(3):
            for ci, ch in enumerate("rgb"):
                assign[r[f"c{vi}{ch}"]] = cols[None, :, vi, ci].expand(p, -1)
    zeros = torch.zeros_like(area)
    # Columns stacked whole, then one transpose: stacking along the last dim
    # would write each column 4 bytes at a 128-byte stride.
    return torch.stack([assign.get(i, zeros) for i in range(N_ATTRS)]).permute(1, 2, 0).contiguous()


def prologue(vertices, colors, faces, face_valid, poses, ks, settings: RasterSettings):
    """Plain-PyTorch prologue of K1 for P poses at once -> (face_rows
    [P, F, 32] f32, slots [P, T, M] int32)."""
    tri_uv, tri_z, valid = project_faces(vertices, faces, face_valid, poses, ks, settings)
    return face_rows(tri_uv, tri_z, colors, faces, settings), bin_faces(tri_uv, valid, settings)


def gather_tile_rows(rows: torch.Tensor, slots: torch.Tensor, tiles: slice) -> torch.Tensor:
    """The attribute matrices [C, 32, M] of `tiles` (a slice of the P·T
    tiles, pose-major) gathered from face rows [P, F, 32] at slots [P, T, M]:
    a slot of -1 reads face 0's row with valid = 0."""
    p, t, m = slots.shape
    sl = slots.reshape(p * t, m)[tiles].long()
    pose = torch.arange(p * t, device=slots.device)[tiles] // t
    at = rows[pose[:, None], sl.clamp(min=0)]  # [C, M, 32]
    at[..., _ROWS["valid"]] *= (sl >= 0).to(at.dtype)
    return at.transpose(1, 2)


def raster_tile_plain(rows: torch.Tensor, slots: torch.Tensor, resolution: int, tile: int, ambient: float,
                      depth_only: bool, chunk: int = 225) -> torch.Tensor:
    """Plain PyTorch version of K1: face rows [P, F, 32] + slots [P, T, M]
    -> the image [P, R, R, 4] (depth, r, g, b), the kernel's arithmetic in
    the same order. Gathers `chunk` tiles' rows at a time (`gather_tile_rows`)
    to bound the [chunk, M, tile²] transients (~180 MB each at 225 tiles,
    M = 256, tile 28)."""
    p, n_tiles, _ = slots.shape
    grid = -(-resolution // tile)
    if n_tiles != grid * grid:
        raise ValueError(f"raster_tile_plain: {n_tiles} tiles per pose, {grid}² at {resolution}/{tile}")
    origins = _tile_origins(grid, tile, rows.device).repeat(p, 1)
    outs = []
    j = torch.arange(tile * tile, device=rows.device)
    fx = (j % tile).to(torch.float32) + 0.5
    fy = torch.div(j, tile, rounding_mode="floor").to(torch.float32) + 0.5
    for s in range(0, p * n_tiles, chunk):
        at = gather_tile_rows(rows, slots, slice(s, s + chunk))
        org = origins[s : s + chunk]

        def row(name):
            return at[:, _ROWS[name], :, None]  # [C, M, 1]

        px = (fx[None] + org[:, 0:1])[:, None, :]  # [C, 1, tp]
        py = (fy[None] + org[:, 1:2])[:, None, :]
        w0 = row("d0x") * (py - row("by")) - row("d0y") * (px - row("bx"))
        w1 = row("d1x") * (py - row("cy")) - row("d1y") * (px - row("cx"))
        w2 = row("d2x") * (py - row("ay")) - row("d2y") * (px - row("ax"))
        s_, ne = row("sgn"), -row("eps")
        covered = (w0 * s_ >= ne) & (w1 * s_ >= ne) & (w2 * s_ >= ne) & (row("valid") > 0.5)
        ia = row("inv_area")
        l0, l1, l2 = w0 * ia, w1 * ia, w2 * ia
        izp = l0 * row("iza") + l1 * row("izb") + l2 * row("izc")
        z = torch.where(covered, 1.0 / torch.clamp(izp, min=1e-12), float("inf"))  # [C, M, tp]
        best = torch.argmin(z, dim=1, keepdim=True)  # ties -> lowest slot
        depth = z.gather(1, best)[:, 0]  # [C, tp]
        hit = torch.isfinite(depth)
        out = torch.zeros(depth.shape + (4,), dtype=torch.float32, device=rows.device)
        out[..., 0] = torch.where(hit, depth, 0.0)
        if not depth_only:
            lw = [l.gather(1, best)[:, 0] for l in (l0, l1, l2)]  # [C, tp]
            bidx = best[:, 0]  # [C, tp]

            def pick(name):
                return at[:, _ROWS[name]].gather(1, bidx)  # [C, tp]

            for ch, cname in enumerate("rgb"):
                c0 = pick(f"c0{cname}") * pick("iza")
                c1 = pick(f"c1{cname}") * pick("izb")
                c2 = pick(f"c2{cname}") * pick("izc")
                v = (lw[0] * c0 + lw[1] * c1 + lw[2] * c2) * torch.where(hit, depth, 0.0) * ambient
                out[..., 1 + ch] = torch.where(hit, torch.clamp(v, 0.0, 1.0), 0.0)
        outs.append(out)
    return tiles_to_images(torch.cat(outs), p, grid, tile, resolution).contiguous()


@functools.lru_cache(maxsize=None)
def _launcher():
    from freepose_tpu_torch.ops import cuda_build

    fn = cuda_build.load("raster_tile").raster_tile_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def raster_tile(rows: torch.Tensor, slots: torch.Tensor, resolution: int, tile: int, ambient: float,
                depth_only: bool) -> torch.Tensor:
    """K1 wrapper: face rows [P, F, 32] f32 + slots [P, T, M] int32 (-1 =
    no face; every other index below F) -> [P, R, R, 4]. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel."""
    name = "raster_tile"
    if rows.device.type == "cpu" and slots.device.type == "cpu":
        return raster_tile_plain(rows, slots, resolution, tile, ambient, depth_only)
    if rows.device.type != "cuda" or slots.device != rows.device:
        raise ValueError(f"{name}: face rows on {rows.device}, slots on {slots.device}")
    if rows.dtype != torch.float32 or slots.dtype != torch.int32:
        raise TypeError(f"{name} takes float32 face rows and int32 slots, got {rows.dtype}, {slots.dtype}")
    grid = -(-resolution // tile)
    if rows.ndim != 3 or rows.shape[2] != N_ATTRS or slots.ndim != 3 or slots.shape[:2] != (rows.shape[0], grid * grid):
        raise ValueError(f"{name}: bad shapes {tuple(rows.shape)}, {tuple(slots.shape)} at {resolution}/{tile}")
    if not (rows.is_contiguous() and slots.is_contiguous()) or rows.data_ptr() % 16:
        raise ValueError(f"{name} takes contiguous tensors, the face rows 16-byte aligned")
    p, f, _ = rows.shape
    out = torch.empty((p, resolution, resolution, 4), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        status = _launcher()(rows.data_ptr(), slots.data_ptr(), out.data_ptr(), p, f, slots.shape[2], resolution,
                             tile, float(ambient), int(depth_only),
                             torch.cuda.current_stream().cuda_stream)
    from freepose_tpu_torch.ops import cuda_build

    cuda_build.check(status, name)
    timing.count("launch.k1")
    return out


def rasterize_cuda(vertices, colors, faces, face_valid, poses, k,
                   settings: RasterSettings = RasterSettings()):
    """Drop-in for rasterizer.rasterize through K1 (same outputs):
    -> (rgb [P, R, R, 3], depth [P, R, R])."""
    ks = k if k.ndim == 3 else k.expand(poses.shape[0], 3, 3)
    rows, slots = prologue(vertices, colors, faces, face_valid, poses, ks, settings)
    img = raster_tile(rows, slots, settings.resolution, settings.tile, settings.ambient, settings.depth_only)
    return img[..., 1:4], img[..., 0]
