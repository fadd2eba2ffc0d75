"""Tile rasterizer on Hopper: plain-PyTorch binning prologue + CUDA kernel K1.

Counterpart of freepose_tpu.ops.rasterizer_pallas. The prologue projects the
mesh for every pose, bins faces into tiles with the shared selection policy
(ops/rasterizer.py:select_tile_faces) and packs each tile's candidate faces
into one [32, M] f32 attribute matrix; the kernel (csrc/raster_tile.cu)
shades every tile pixel from that matrix in shared memory. The output is
pixel-identical to the plain rasterizer: same binning, same seam epsilon,
same z-winner, same rounding (the kernel is built without FMA contraction).

`raster_tile` is the kernel's wrapper: a CUDA tensor launches K1 (or
raises), a CPU tensor runs `raster_tile_plain`, the same arithmetic in
PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from freepose_tpu_torch.ops.rasterizer import (
    RasterSettings,
    _project_vertices,
    _tile_origins,
    select_tile_faces,
    tiles_to_images,
)

# Attribute-matrix rows (N_ATTRS × faces); csrc/raster_tile.cu uses the same
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


def _bin_and_pack(vertices, colors, faces, face_valid, poses, ks, settings: RasterSettings):
    """Plain-PyTorch prologue for P poses at once -> (attrs [P·T, 32, M] f32,
    origins [P·T, 2] f32). Invalid slots carry valid = 0."""
    res, tile = settings.resolution, settings.tile
    grid = -(-res // tile)
    n_tiles = grid * grid
    p = poses.shape[0]
    faces = faces.long()
    m = min(settings.max_faces_per_tile, faces.shape[0])

    uv, z = _project_vertices(vertices, poses, ks)  # [P, V, 2], [P, V]
    tri_uv = uv[:, faces]  # [P, F, 3, 2]
    tri_z = z[:, faces]  # [P, F, 3]
    valid = face_valid & (tri_z > settings.znear).all(dim=-1)
    top_idx, sel_valid = select_tile_faces(
        tri_uv.amin(dim=2), tri_uv.amax(dim=2), valid, grid, tile, m, settings.binning
    )  # [P, T, m]

    # Per-face attribute rows first, then one full-row gather per (tile, slot).
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
        r["valid"]: nondegen.to(torch.float32),  # ANDed with sel_valid below
    }
    if not settings.depth_only:
        cols = colors[faces]  # [F, 3 vertices, 3 channels]
        for vi in range(3):
            for ci, ch in enumerate("rgb"):
                assign[r[f"c{vi}{ch}"]] = cols[None, :, vi, ci].expand(p, -1)
    zeros = torch.zeros_like(area)
    face_rows = torch.stack([assign.get(i, zeros) for i in range(N_ATTRS)], dim=-1)  # [P, F, 32]
    idx = top_idx.reshape(p, n_tiles * m).long()
    gathered = face_rows.gather(1, idx[..., None].expand(-1, -1, N_ATTRS))
    gathered = gathered.reshape(p, n_tiles, m, N_ATTRS)
    gathered[..., r["valid"]] *= sel_valid.to(torch.float32)
    attrs = gathered.transpose(2, 3).reshape(p * n_tiles, N_ATTRS, m).contiguous()
    origins = _tile_origins(grid, tile, vertices.device).repeat(p, 1)
    return attrs, origins


def raster_tile_plain(attrs: torch.Tensor, origins: torch.Tensor, tile: int, ambient: float,
                      depth_only: bool, chunk: int = 225) -> torch.Tensor:
    """Plain PyTorch version of K1: [PT, 32, M] attrs + [PT, 2] origins ->
    [PT, tile², 4] (depth, r, g, b), the kernel's arithmetic in the same
    order. Runs `chunk` tiles at a time to bound the [chunk, M, tile²]
    transients (~180 MB each at 225 tiles, M = 256, tile 28)."""
    outs = []
    j = torch.arange(tile * tile, device=attrs.device)
    fx = (j % tile).to(torch.float32) + 0.5
    fy = torch.div(j, tile, rounding_mode="floor").to(torch.float32) + 0.5
    for s in range(0, attrs.shape[0], chunk):
        at = attrs[s : s + chunk]
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
        best = torch.argmin(z, dim=1, keepdim=True)  # ties -> lowest face
        depth = z.gather(1, best)[:, 0]  # [C, tp]
        hit = torch.isfinite(depth)
        out = torch.zeros(depth.shape + (4,), dtype=torch.float32, device=attrs.device)
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
    return torch.cat(outs)


def raster_tile(attrs: torch.Tensor, origins: torch.Tensor, tile: int, ambient: float,
                depth_only: bool) -> torch.Tensor:
    """K1 wrapper: [PT, 32, M] f32 attrs + [PT, 2] f32 origins -> [PT, tile², 4].
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel."""
    if attrs.device.type == "cpu":
        return raster_tile_plain(attrs, origins, tile, ambient, depth_only)
    if attrs.device.type != "cuda" or origins.device != attrs.device:
        raise ValueError(f"raster_tile: attrs on {attrs.device}, origins on {origins.device}")
    if attrs.dtype != torch.float32 or origins.dtype != torch.float32:
        raise TypeError("raster_tile takes float32 attrs and origins")
    if attrs.ndim != 3 or attrs.shape[1] != N_ATTRS or origins.shape != (attrs.shape[0], 2):
        raise ValueError(f"raster_tile: bad shapes {tuple(attrs.shape)}, {tuple(origins.shape)}")
    if not (attrs.is_contiguous() and origins.is_contiguous()):
        raise ValueError("raster_tile takes contiguous tensors")
    from freepose_tpu_torch.ops import cuda_build

    lib = cuda_build.load("raster_tile")
    fn = lib.raster_tile_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pt, _, m = attrs.shape
    out = torch.empty((pt, tile * tile, 4), dtype=torch.float32, device=attrs.device)
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(attrs.data_ptr(), origins.data_ptr(), out.data_ptr(), pt, m, tile,
                    float(ambient), int(depth_only), stream)
    cuda_build.check(status, "raster_tile")
    raster_tile.launches += 1
    return out


raster_tile.launches = 0


def rasterize_cuda(vertices, colors, faces, face_valid, poses, k,
                   settings: RasterSettings = RasterSettings()):
    """Drop-in for rasterizer.rasterize through K1 (same outputs):
    -> (rgb [P, R, R, 3], depth [P, R, R])."""
    res, tile = settings.resolution, settings.tile
    grid = -(-res // tile)
    p = poses.shape[0]
    ks = k if k.ndim == 3 else k.expand(p, 3, 3)
    attrs, origins = _bin_and_pack(vertices, colors, faces, face_valid, poses, ks, settings)
    out = raster_tile(attrs, origins, tile, settings.ambient, settings.depth_only)
    img = tiles_to_images(out, p, grid, tile, res)
    return img[..., 1:4], img[..., 0]
