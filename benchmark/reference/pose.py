"""The pose arithmetic of the coupled video step, plain: crops of a frame
around a mask, template views rendered and cropped, their cloud statistics,
mean patch-cosine scores, the fine-grid neighbourhood and the bbox z-lift.
Each function follows the port's pipeline module of the same role at the
commit that added the benchmark (pipeline/proposals.py, renderer.py,
template_bank.py, pose_estimator.py, online_pose_estimator.py)."""
from __future__ import annotations

import torch

from benchmark.reference.frozen.boxes import mask_to_bbox
from benchmark.reference.frozen.camera import backproject_depth
from benchmark.reference.frozen.crop import crop_resize_pad
from benchmark.reference.frozen.pointcloud import masked_mean
from benchmark.reference.frozen.rasterizer import RasterSettings, render_meshes
from benchmark.reference.frozen.rotation import geodesic_distance, template_poses

TEMPLATE_FOCAL, TEMPLATE_RES, TEMPLATE_Z = 600.0, 420, 1.1
RENDERING_SCALE = 0.25
DEGENERATE_MASK_MIN_PX = 100


def template_intrinsics(res: int, device) -> torch.Tensor:
    f = TEMPLATE_FOCAL * res / TEMPLATE_RES
    return torch.tensor([[f, 0.0, res / 2], [0.0, f, res / 2], [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def frame_crops(frames: torch.Tensor, masks: torch.Tensor, target: int, extend: float):
    """[K, H, W, 3] uint8 frames and [K, H, W] bool masks -> (crops [K, 3,
    T, T], mask crops [K, T, T], bboxes [K, 4]): the masked RGB and the mask
    cropped square around the mask's box (an empty mask: the centred half
    frame)."""
    kf, h, w = masks.shape
    empty = ~masks.reshape(kf, -1).any(dim=1)
    fallback = torch.tensor([w * 0.25, h * 0.25, w * 0.75, h * 0.75], dtype=torch.float32, device=frames.device)
    bboxes = torch.where(empty[:, None], fallback, mask_to_bbox(masks).to(torch.float32))
    img = frames.to(torch.float32) / 255.0
    rgb = torch.where(masks[:, None], img.permute(0, 3, 1, 2), torch.zeros((), device=frames.device))
    crops = crop_resize_pad(rgb, bboxes, target, extend=extend)
    mask_crops = crop_resize_pad(masks[:, None].to(torch.float32), bboxes, target, extend=extend)[:, 0] > 0.5
    return crops, mask_crops, bboxes


def render_views(mesh, poses: torch.Tensor, res: int, chunk: int = 128):
    """The mesh (vertices, faces, colours on the device) at quarter scale
    from `poses` in the template camera -> (crops [P, 3, res, res], stats
    (min, max, mean) [P, 3] each of the views' point clouds)."""
    verts, faces, colors = mesh
    valid = torch.ones(faces.shape[0], dtype=torch.bool, device=verts.device)
    k = template_intrinsics(res, verts.device)
    rgb, depth = render_meshes(verts * RENDERING_SCALE, colors, faces, valid, poses, k,
                               RasterSettings(resolution=res), pose_chunk=chunk)
    masks = depth > 0
    q = res // 4
    fallback = torch.zeros((res, res), dtype=torch.bool, device=depth.device)
    fallback[q:res - q, q:res - q] = True
    small = masks.sum(dim=(1, 2)) < DEGENERATE_MASK_MIN_PX
    masks = torch.where(small[:, None, None], fallback[None], masks)
    crops = crop_resize_pad(rgb.permute(0, 3, 1, 2), mask_to_bbox(masks), res)
    return crops, depth_stats(depth, k)


def depth_stats(depths: torch.Tensor, k: torch.Tensor):
    pts, valid = backproject_depth(depths, k)
    big = torch.tensor(1e30, dtype=pts.dtype, device=pts.device)
    vmin = torch.where(valid[..., None], pts, big).amin(dim=1)
    vmax = torch.where(valid[..., None], pts, -big).amax(dim=1)
    mean = masked_mean(pts, valid, axis=1)
    any_valid = valid.any(dim=1, keepdim=True)
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    return torch.where(any_valid, vmin, zero), torch.where(any_valid, vmax, zero), mean


def view_scores(view_feats: torch.Tensor, query_feat: torch.Tensor) -> torch.Tensor:
    """Mean patch cosine of each view [V, G², D] with the query [G², D]."""
    return (view_feats * query_feat[None]).sum(dim=-1).mean(dim=-1)


def lift(stats, i: int, k: torch.Tensor, bbox: torch.Tensor, est_scale: float) -> torch.Tensor:
    """The translation [3] the bbox z-lift gives view i."""
    pc_min, pc_max, pc_mean = (s[i] for s in stats)
    s = est_scale / RENDERING_SCALE
    mins, maxs = (pc_min - pc_mean) * s + pc_mean, (pc_max - pc_mean) * s + pc_mean
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    z = (fx * (maxs[0] - mins[0]) / (bbox[2] - bbox[0] + 1.0) + fy * (maxs[1] - mins[1]) / (bbox[3] - bbox[1] + 1.0)) / 2
    return torch.stack([((bbox[0] + bbox[2]) / 2 - cx) * z / fx, ((bbox[1] + bbox[3]) / 2 - cy) * z / fy, z])


def grid(n: int, device) -> torch.Tensor:
    return template_poses(n, z=TEMPLATE_Z, device=device)


def neighborhood(grid_poses: torch.Tensor, prev_rot: torch.Tensor, deg: float, n: int):
    """The n grid poses nearest prev_rot (ties: lowest index) and which lie
    within `deg` (the nearest always) -> (indices [n], valid [n])."""
    d = geodesic_distance(grid_poses[:, :3, :3], prev_rot)
    idx = torch.argsort(d, stable=True)[:n]
    valid = d[idx] < deg
    valid[0] = True
    return idx, valid


def grid_index(grid_poses: torch.Tensor, rot: torch.Tensor, candidates: torch.Tensor) -> tuple[int, float]:
    """The candidate grid pose whose rotation is nearest `rot`, and its
    distance in degrees."""
    d = geodesic_distance(grid_poses[candidates, :3, :3], rot)
    j = int(torch.argmin(d))
    return j, float(d[j])
