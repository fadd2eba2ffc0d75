"""EPnP, frozen: a copy of the port's pipeline/pnp.py (Lepetit et al., IJCV
2009) at the commit that added the smooth cell, cut to `epnp`. Four control
points on the principal axes, barycentric coordinates, the null space of the
2N x 12 projection system, a closed-form scale polished by 10 Gauss-Newton
steps, the sign that puts the points in front of the camera, a Kabsch
solve; masked rows count for nothing. The symmetric eigen-solves go through
LAPACK's ssyevd (scipy), on the host in float32, as the port's do."""
from __future__ import annotations

import numpy as np
import scipy.linalg.lapack
import torch

_PAIRS = torch.triu_indices(4, 4, offset=1)  # the 6 control-point pairs (i < j), row-major


def _eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvectors of symmetric [..., n, n]
    host float32 matrices, symmetrized first and solved by ssyevd (lower)."""
    x = a.detach().cpu().numpy().astype(np.float32)
    x = ((x + np.swapaxes(x, -1, -2)) / 2).reshape((-1,) + x.shape[-2:])
    vals, vecs = np.empty(x.shape[:-1], np.float32), np.empty_like(x)
    for i, m in enumerate(x):
        vals[i], vecs[i], info = scipy.linalg.lapack.ssyevd(m, compute_v=1, lower=1)
        if info:
            raise np.linalg.LinAlgError(f"ssyevd failed with info {info}")
    return (torch.from_numpy(vals.reshape(a.shape[:-1])).to(a.device),
            torch.from_numpy(vecs.reshape(a.shape)).to(a.device))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[..., N, C] rows where mask [..., N] -> [..., C] (0 without a row)."""
    return (x * mask[..., None]).sum(dim=-2) / torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)


def _kabsch(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor):
    """Rigid transform (no scale) taking the masked src rows onto dst ->
    (r [..., 3, 3], t [..., 3])."""
    mu_s, mu_d = _masked_mean(src, mask), _masked_mean(dst, mask)
    s = (src - mu_s[..., None, :]) * mask[..., None]
    d = (dst - mu_d[..., None, :]) * mask[..., None]
    u, _, vt = torch.linalg.svd(s.transpose(-1, -2) @ d)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    diag = torch.ones(u.shape[:-1], dtype=u.dtype, device=u.device)
    diag[..., 2] = torch.linalg.det(v @ ut)
    r = v @ torch.diag_embed(diag) @ ut
    return r, mu_d - (r @ mu_s[..., None])[..., 0]


def _pair_d2(c: torch.Tensor) -> torch.Tensor:
    """[..., 4, 3] control points -> [..., 6] squared pair distances."""
    d = c[..., _PAIRS[0], :] - c[..., _PAIRS[1], :]
    return (d * d).sum(dim=-1)


def epnp(world_pts: torch.Tensor, image_pts: torch.Tensor, k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """world_pts [..., N, 3], image_pts [..., N, 2] pixels, k [3, 3], mask
    [..., N] (at least 4 valid rows for a meaningful pose) -> [..., 4, 4]
    camera-from-world poses."""
    batch = torch.broadcast_shapes(world_pts.shape[:-2], image_pts.shape[:-2], mask.shape[:-1])
    n = world_pts.shape[-2]
    world_pts = world_pts.expand(batch + (n, 3))
    m = mask.expand(batch + (n,)).to(torch.float32)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]

    # Control points: the centroid and the principal axes.
    c0 = _masked_mean(world_pts, m)
    centered = (world_pts - c0[..., None, :]) * m[..., None]
    cov = centered.transpose(-1, -2) @ centered / torch.clamp(m.sum(dim=-1), min=1.0)[..., None, None]
    eigval, eigvec = _eigh(cov)
    axes = eigvec * torch.sqrt(torch.clamp(eigval, min=1e-10))[..., None, :]  # a floor for planar clouds
    ctrl_w = torch.cat([c0[..., None, :], c0[..., None, :] + axes.transpose(-1, -2)], dim=-2)  # [..., 4, 3]

    # Barycentric coordinates.
    a_mat = (ctrl_w[..., 1:, :] - ctrl_w[..., :1, :]).transpose(-1, -2)
    a123 = torch.linalg.solve(a_mat, (world_pts - c0[..., None, :]).transpose(-1, -2)).transpose(-1, -2)
    alphas = torch.cat([1.0 - a123.sum(dim=-1, keepdim=True), a123], dim=-1)  # [..., N, 4]

    # M (2N x 12) in normalized image coordinates (entries O(1)).
    xn = (image_pts[..., 0] - cx) / fx
    yn = (image_pts[..., 1] - cy) / fy
    zeros = torch.zeros_like(alphas)
    row_u = torch.stack([alphas, zeros, -alphas * xn[..., None]], dim=-1).reshape(batch + (n, 12))
    row_v = torch.stack([zeros, alphas, -alphas * yn[..., None]], dim=-1).reshape(batch + (n, 12))
    mm = torch.cat([row_u * m[..., None], row_v * m[..., None]], dim=-2)
    vecs = _eigh(mm.transpose(-1, -2) @ mm)[1]
    basis = vecs[..., :, :4].transpose(-1, -2).reshape(batch + (4, 4, 3))  # the 4 smallest null vectors

    # Betas: a closed form on the smallest vector, then Gauss-Newton.
    dw2 = _pair_d2(ctrl_w)
    v0 = basis[..., 0, :, :]
    beta0 = (torch.sqrt(dw2) * torch.sqrt(_pair_d2(v0) + 1e-12)).sum(-1) / torch.clamp(_pair_d2(v0).sum(-1),
                                                                                         min=1e-12)
    betas = torch.zeros(batch + (4,), dtype=world_pts.dtype, device=world_pts.device)
    betas[..., 0] = beta0
    vdiff = basis[..., _PAIRS[0], :] - basis[..., _PAIRS[1], :]  # [..., 4, 6, 3]
    eye4 = torch.eye(4, dtype=betas.dtype, device=betas.device)
    for _ in range(10):
        ctrl = torch.einsum("...k,...kij->...ij", betas, basis)
        diff = ctrl[..., _PAIRS[0], :] - ctrl[..., _PAIRS[1], :]  # [..., 6, 3]
        resid = (diff * diff).sum(-1) - dw2
        jac = 2.0 * torch.einsum("...pd,...kpd->...pk", diff, vdiff)  # [..., 6, 4]
        jt = jac.transpose(-1, -2)
        betas = betas - torch.linalg.solve(jt @ jac + 1e-9 * eye4, (jt @ resid[..., None]))[..., 0]

    cam_pts = alphas @ torch.einsum("...k,...kij->...ij", betas, basis)  # [..., N, 3]
    mean_z = (cam_pts[..., 2] * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    cam_pts = torch.where(mean_z[..., None, None] < 0, -cam_pts, cam_pts)
    r, t = _kabsch(world_pts, cam_pts, m)
    pose = torch.eye(4, dtype=r.dtype, device=r.device).repeat(batch + (1, 1))
    pose[..., :3, :3] = r
    pose[..., :3, 3] = t
    return pose
