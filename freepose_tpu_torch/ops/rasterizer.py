"""Batched triangle rasterizer (RGB + depth, z-buffered), PyTorch.

Counterpart of freepose_tpu.ops.rasterizer. The image is split into
TILE×TILE tiles; each tile rasterizes at most `max_faces_per_tile` candidate
faces (the lowest-index valid faces whose screen bbox overlaps it), with
perspective-correct depth and vertex colours, no face culling, a seam
tolerance of 1e-5·|area| and z-ties broken toward the lowest face index.

Dispatch (`RasterSettings.backend`):
  * "auto": a CUDA tensor goes to the hand-written tile kernel K1
    (ops/rasterizer_cuda.py, csrc/raster_tile.cu), a CPU tensor to the plain
    version below;
  * "xla": the plain version on any device (the name of the JAX package's
    dense path is kept so settings read the same in both packages);
  * "pallas" / "kernel": K1; a CPU tensor raises.
"""
from __future__ import annotations

import dataclasses

import torch

from freepose_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    resolution: int = 420
    tile: int = 28
    max_faces_per_tile: int = 256
    ambient: float = 2.0  # match pyrender Scene(ambient_light=2.0) look
    znear: float = 1e-4
    depth_only: bool = False  # skip color interpolation (silhouette/eval renders)
    backend: str = "auto"  # "auto" | "xla" (plain) | "pallas"/"kernel" (K1)
    # Tile binning, identical selection either way: "sort" (one global sort
    # of (tile, face) keys) or "topk" (dense per-tile top-k over all faces).
    binning: str = "sort"


_INT_MAX = torch.iinfo(torch.int64).max


def select_tile_faces(
    bb_min: torch.Tensor,  # [..., F, 2] face screen-bbox min (u, v)
    bb_max: torch.Tensor,  # [..., F, 2]
    valid: torch.Tensor,  # [..., F] bool
    grid: int,
    tile: int,
    m: int,
    binning: str = "sort",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile candidate faces: the `m` LOWEST-INDEX valid faces whose screen
    bbox overlaps each tile rectangle [tx, tx+tile]×[ty, ty+tile] (boundary
    inclusive). Returns (top_idx [..., T, m] int32, sel_valid [..., T, m]
    bool), candidates packed ascending by face index. Leading dims batch
    poses. Entries where sel_valid is False carry an arbitrary index.

    "topk" scores every (tile, face) pair; "sort" gives the identical
    selection from one sort of the ≤16 tile keys of each small face (bbox
    within 4×4 tiles) plus a dense test of at most 512 bigger faces (see
    freepose_tpu.ops.rasterizer.select_tile_faces for the argument)."""
    batch = valid.shape[:-1]
    f_total = valid.shape[-1]
    bb_min = bb_min.reshape(-1, f_total, 2)
    bb_max = bb_max.reshape(-1, f_total, 2)
    valid = valid.reshape(-1, f_total)
    dev = valid.device
    n_tiles = grid * grid
    m = min(m, f_total)
    tile_ids = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    tx = (tile_ids % grid) * tile
    ty = torch.div(tile_ids, grid, rounding_mode="floor") * tile
    f_idx = torch.arange(f_total, dtype=torch.float32, device=dev)
    with timing.wait("rasterizer.select_tile_faces"):  # an upload from pageable memory synchronises
        neg_inf = torch.tensor(-float("inf"), device=dev)

    def _out(idx, ok):
        return idx.reshape(batch + idx.shape[1:]), ok.reshape(batch + ok.shape[1:])

    if binning == "topk":
        ox = (bb_min[:, None, :, 0] <= (tx + tile)[:, None]) & (bb_max[:, None, :, 0] >= tx[:, None])
        oy = (bb_min[:, None, :, 1] <= (ty + tile)[:, None]) & (bb_max[:, None, :, 1] >= ty[:, None])
        overlap = ox & oy & valid[:, None, :]  # [B, T, F]
        sel_scores = torch.where(overlap, -f_idx, neg_inf)
        top_vals, top_idx = torch.topk(sel_scores, m, dim=-1)
        return _out(top_idx.to(torch.int32), torch.isfinite(top_vals))
    if binning != "sort":
        raise ValueError(f"unknown binning {binning!r}")

    span = 4  # small faces: bbox within a span×span tile window
    big_cap = min(512, f_total)
    # Safe integer bounds on the overlapped tile range (see the JAX version).
    i0 = torch.floor(bb_min / tile).to(torch.int64) - 1  # [B, F, 2]
    i1 = torch.floor(bb_max / tile).to(torch.int64)
    small = valid & (i1 <= i0 + (span - 1)).all(dim=-1)

    dx = torch.arange(span, dtype=torch.int64, device=dev)
    ti = i0[..., 0:1] + dx  # [B, F, span] candidate tile cols
    tj = i0[..., 1:2] + dx  # [B, F, span] candidate tile rows
    fx = tile * 1.0
    ox = (
        (bb_min[..., 0:1] <= (ti + 1) * fx) & (bb_max[..., 0:1] >= ti * fx)
        & (ti >= 0) & (ti < grid)
    )
    oy = (
        (bb_min[..., 1:2] <= (tj + 1) * fx) & (bb_max[..., 1:2] >= tj * fx)
        & (tj >= 0) & (tj < grid)
    )
    ent_ok = small[..., None, None] & ox[..., :, None] & oy[..., None, :]  # [B, F, sx, sy]
    ent_tile = tj[..., None, :] * grid + ti[..., :, None]
    face_ids = torch.arange(f_total, dtype=torch.int64, device=dev)[:, None, None]
    key = torch.where(ent_ok, ent_tile * f_total + face_ids, _INT_MAX)
    key = key.reshape(key.shape[0], -1)
    if key.shape[1] < m:
        pad = torch.full((key.shape[0], m - key.shape[1]), _INT_MAX, dtype=key.dtype, device=dev)
        key = torch.cat([key, pad], dim=1)
    keys = torch.sort(key, dim=-1).values
    bsz, n_keys = keys.shape
    starts = torch.searchsorted(keys, (tile_ids * f_total).expand(bsz, n_tiles).contiguous())
    # lax.dynamic_slice clamps the window start to [0, len - m]; do the same.
    starts = torch.clamp(starts, max=n_keys - m)
    win_pos = (starts[..., None] + torch.arange(m, device=dev)).reshape(bsz, -1)
    win = keys.gather(1, win_pos).reshape(bsz, n_tiles, m)  # [B, T, m]
    win_ok = torch.div(win, f_total, rounding_mode="floor") == tile_ids[:, None]
    small_cand = torch.where(win_ok, (win % f_total).to(torch.float32), float("inf"))

    big_vals, big_idx = torch.topk(torch.where(valid & ~small, -f_idx, neg_inf), big_cap, dim=-1)
    big_ok = torch.isfinite(big_vals)  # [B, L]
    b0 = torch.gather(bb_min, 1, big_idx[..., None].expand(-1, -1, 2))  # [B, L, 2]
    b1 = torch.gather(bb_max, 1, big_idx[..., None].expand(-1, -1, 2))
    bx = (b0[:, None, :, 0] <= (tx + tile)[:, None]) & (b1[:, None, :, 0] >= tx[:, None])
    by = (b0[:, None, :, 1] <= (ty + tile)[:, None]) & (b1[:, None, :, 1] >= ty[:, None])
    big_cand = torch.where(
        bx & by & big_ok[:, None, :], big_idx.to(torch.float32)[:, None, :], float("inf")
    )  # [B, T, L]

    cand = torch.cat([small_cand, big_cand], dim=-1)  # [B, T, m + L]
    top_vals, _ = torch.topk(-cand, m, dim=-1)
    sel_valid = torch.isfinite(top_vals)
    top_idx = torch.where(sel_valid, -top_vals, 0.0).to(torch.int32)
    return _out(top_idx, sel_valid)


def camera_points(vertices: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Object-space vertices [..., V, 3] -> camera coordinates [..., V, 3]
    (`pose` [..., 4, 4] batches over leading dims).

    The rotation is written out term by term (no matmul, so TF32 never
    enters) and rounds as the fused multiply-add chain that XLA's CPU dot
    emits, fma(v2, r2, fma(v1, r1, v0·r0)): each fma is one float64 multiply
    and add (exact product) rounded once to float32. Screen positions then
    agree bit for bit with the JAX reference, which keeps seam pixels and
    barycentrics identical on every device."""
    r = pose[..., None, :3, :3]  # [..., 1, 3, 3]
    t = pose[..., None, :3, 3]

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).to(torch.float32)

    cam = vertices[..., 0:1] * r[..., 0]
    cam = fma(vertices[..., 1:2], r[..., 1], cam)
    return fma(vertices[..., 2:3], r[..., 2], cam) + t


def _project_vertices(vertices: torch.Tensor, pose: torch.Tensor, k: torch.Tensor):
    """Object-space vertices [..., V, 3] -> (screen uv [..., V, 2], camera z
    [..., V]). `pose` [..., 4, 4] and `k` [..., 3, 3] batch over leading
    dims; the camera points as `camera_points`."""
    cam = camera_points(vertices, pose)
    z = cam[..., 2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = k[..., 0, 0, None] * cam[..., 0] / safe_z + k[..., 0, 2, None]
    v = k[..., 1, 1, None] * cam[..., 1] / safe_z + k[..., 1, 2, None]
    return torch.stack([u, v], dim=-1), z


def _tile_origins(grid: int, tile: int, device) -> torch.Tensor:
    """[T, 2] float32 (x, y) pixel origin of each tile, row-major tile order."""
    tile_ids = torch.arange(grid * grid, device=device)
    tx = (tile_ids % grid) * tile
    ty = torch.div(tile_ids, grid, rounding_mode="floor") * tile
    return torch.stack([tx, ty], dim=-1).to(torch.float32)


def tiles_to_images(out: torch.Tensor, p: int, grid: int, tile: int, res: int) -> torch.Tensor:
    """[P·T, tile², C] per-tile pixels -> [P, res, res, C] images."""
    c = out.shape[-1]
    out = out.reshape(p, grid, grid, tile, tile, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(p, grid * tile, grid * tile, c)[:, :res, :res]


def _rasterize_plain_one(vertices, colors, faces, face_valid, pose, k, settings):
    """One pose through the dense path: [T, M, tile²] edge functions."""
    res, tile = settings.resolution, settings.tile
    grid = -(-res // tile)
    m = min(settings.max_faces_per_tile, faces.shape[0])
    uv, z = _project_vertices(vertices, pose, k)
    tri_uv = uv[faces]  # [F, 3, 2]
    tri_z = z[faces]  # [F, 3]
    in_front = (tri_z > settings.znear).all(dim=-1)
    valid = face_valid & in_front

    bb_min = tri_uv.amin(dim=1)
    bb_max = tri_uv.amax(dim=1)
    top_idx, sel_valid = select_tile_faces(bb_min, bb_max, valid, grid, tile, m, settings.binning)
    # Each tile's candidates come first (ascending face index); the slots
    # after the fullest tile's last candidate hold no face in any tile, and
    # cutting them leaves every z-winner and hit as it is.
    held = max(1, int(sel_valid.sum(dim=-1).max()))
    # Only tiles that hold a face are shaded; the others stay empty (0).
    busy = sel_valid.any(dim=-1).nonzero()[:, 0]
    top_idx, sel_valid = top_idx[busy, :held].long(), sel_valid[busy, :held]

    tri_uv_t = tri_uv[top_idx]  # [T, M, 3, 2]
    tri_z_t = tri_z[top_idx]  # [T, M, 3]

    px = torch.arange(tile, dtype=torch.float32, device=vertices.device) + 0.5
    pyy, pxx = torch.meshgrid(px, px, indexing="ij")
    pix = torch.stack([pxx.reshape(-1), pyy.reshape(-1)], dim=-1)  # [tp, 2]
    pix_t = _tile_origins(grid, tile, vertices.device)[busy, None, :] + pix[None]  # [T, tp, 2]

    a = tri_uv_t[:, :, 0, :]  # [T, M, 2]
    b = tri_uv_t[:, :, 1, :]
    c = tri_uv_t[:, :, 2, :]

    def edge(p, q, x):
        # cross(q - p, x - p): [T, M, 2] x [T, tp, 2] -> [T, M, tp]
        d = q - p
        return (
            d[:, :, None, 0] * (x[:, None, :, 1] - p[:, :, None, 1])
            - d[:, :, None, 1] * (x[:, None, :, 0] - p[:, :, None, 0])
        )

    w0 = edge(b, c, pix_t)  # weight of vertex a
    w1 = edge(c, a, pix_t)
    w2 = edge(a, b, pix_t)
    area = (
        (b[:, :, 0] - a[:, :, 0]) * (c[:, :, 1] - a[:, :, 1])
        - (b[:, :, 1] - a[:, :, 1]) * (c[:, :, 0] - a[:, :, 0])
    )[:, :, None]  # [T, M, 1]

    s = torch.sign(area)
    eps = 1e-5 * area.abs()
    nondegen = area.abs() > 1e-12
    covered = (w0 * s >= -eps) & (w1 * s >= -eps) & (w2 * s >= -eps)
    covered &= nondegen & sel_valid[:, :, None]

    inv_area = torch.where(nondegen, 1.0 / area, torch.zeros_like(area))
    l0 = w0 * inv_area
    l1 = w1 * inv_area
    l2 = w2 * inv_area
    iz = 1.0 / torch.clamp(tri_z_t, min=settings.znear)  # [T, M, 3]
    iz_pix = l0 * iz[:, :, 0:1] + l1 * iz[:, :, 1:2] + l2 * iz[:, :, 2:3]
    z_pix = 1.0 / torch.clamp(iz_pix, min=1e-12)
    z_pix = torch.where(covered, z_pix, float("inf"))

    best = torch.argmin(z_pix, dim=1, keepdim=True)  # [T, 1, tp]; ties -> lowest index
    depth_tile = z_pix.gather(1, best)[:, 0]  # [T, tp]
    hit = torch.isfinite(depth_tile)
    out = torch.zeros(depth_tile.shape + (4,), dtype=torch.float32, device=vertices.device)
    out[..., 0] = torch.where(hit, depth_tile, 0.0)
    if not settings.depth_only:
        # Interpolate only the z-winner's colour (the same elementwise
        # arithmetic as shading every candidate and picking the winner).
        tri_col_t = colors[faces][top_idx]  # [T, M, 3, 3]
        col_over_z = tri_col_t * iz[..., None]  # [T, M, 3 vertices, 3 channels]
        bc = best[:, 0, :, None].expand(-1, -1, 3)  # [T, tp, 3]
        coz = [col_over_z[:, :, v, :].gather(1, bc) for v in range(3)]  # [T, tp, 3]
        lw = [l.gather(1, best)[:, 0, :, None] for l in (l0, l1, l2)]  # [T, tp, 1]
        zsel = torch.where(hit, depth_tile, 0.0)[..., None]
        rgb = (lw[0] * coz[0] + lw[1] * coz[1] + lw[2] * coz[2]) * zsel
        rgb = torch.clamp(rgb * settings.ambient, 0.0, 1.0)
        out[..., 1:] = torch.where(hit[..., None], rgb, 0.0)
    full = torch.zeros((grid * grid,) + out.shape[1:], dtype=out.dtype, device=out.device)
    full[busy] = out
    return full  # [T, tp, 4]


def rasterize_plain(vertices, colors, faces, face_valid, poses, k, settings=RasterSettings()):
    """Plain PyTorch rasterizer, one pose at a time (each pose already holds
    T·M·tile² work; batching poses would multiply the ~180 MB [T, M, tile²]
    transients at 420²)."""
    res, tile = settings.resolution, settings.tile
    grid = -(-res // tile)
    p = poses.shape[0]
    ks = k if k.ndim == 3 else k.expand(p, 3, 3)
    faces = faces.long()
    out = torch.stack([
        _rasterize_plain_one(vertices, colors, faces, face_valid, poses[i], ks[i], settings)
        for i in range(p)
    ])
    img = tiles_to_images(out.reshape(p * grid * grid, tile * tile, 4), p, grid, tile, res)
    return img[..., 1:4], img[..., 0]


def rasterize(
    vertices: torch.Tensor,  # [V, 3] float32 object-space
    colors: torch.Tensor,  # [V, 3] float32 in [0, 1]
    faces: torch.Tensor,  # [F, 3] int
    face_valid: torch.Tensor,  # [F] bool (padding mask)
    poses: torch.Tensor,  # [P, 4, 4] camera-from-object (OpenCV convention)
    k: torch.Tensor,  # [3, 3] intrinsics, or [P, 3, 3] per-pose
    settings: RasterSettings = RasterSettings(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render P poses -> (rgb [P, R, R, 3] in [0,1], depth [P, R, R])."""
    backend = settings.backend
    if backend == "xla" or (backend == "auto" and vertices.device.type == "cpu"):
        return rasterize_plain(vertices, colors, faces, face_valid, poses, k, settings)
    if backend not in ("auto", "pallas", "kernel"):
        raise ValueError(f"unknown raster backend {backend!r}")
    if vertices.device.type != "cuda":
        raise ValueError(f"raster backend {backend!r} runs on a CUDA tensor, got {vertices.device}")
    from freepose_tpu_torch.ops.rasterizer_cuda import rasterize_cuda

    return rasterize_cuda(vertices, colors, faces, face_valid, poses, k, settings)


def render_meshes(vertices, colors, faces, face_valid, poses, k,
                  settings: RasterSettings = RasterSettings(), pose_chunk: int | None = None):
    """rasterize() with optional chunking over poses to bound memory."""
    if pose_chunk is None or poses.shape[0] <= pose_chunk:
        return rasterize(vertices, colors, faces, face_valid, poses, k, settings)
    rgbs, depths = [], []
    for i in range(0, poses.shape[0], pose_chunk):
        ki = k if k.ndim == 2 else k[i : i + pose_chunk]
        r, d = rasterize(vertices, colors, faces, face_valid, poses[i : i + pose_chunk], ki, settings)
        rgbs.append(r)
        depths.append(d)
    return torch.cat(rgbs), torch.cat(depths)
