"""StreamingInliers' counts, plain: for every frame of a video and the pose
given for it, the photo cropped around the projected model, the mesh
rendered at the crop's intrinsics, DINOv2-B's patch features of both and
their masked patch cosine [37, 37]; the threshold keeps the top fifth of
the video's positive cosines, and a frame's count is its cosines above it.
Where the sorted cosines thin out at the top fifth, a few cosines that
rounding moves across nought shift the threshold across the thin stretch:
so the counts are judged at the threshold the program took, and that
threshold by its rank among the reference's cosines (rank_err).
Follows pipeline/tracking_refiner.py (_confidence_block, quantile_threshold)
and io/mesh.py (sample_surface) at the commit that added the benchmark."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import models
from benchmark.reference.frozen.camera import crop_bbox_around_projection, update_k_with_crop
from benchmark.reference.frozen.rasterizer import RasterSettings, render_meshes
from benchmark.reference.frozen.sampling import resize_area, roi_align

RES, PATCH = 518, 14
GRID = RES // PATCH
TOP_QUANTILE = 0.2
SURFACE_POINTS, SURFACE_SEED = 100, 42
SETTINGS = RasterSettings(resolution=RES, tile=37, max_faces_per_tile=256)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Area-weighted uniform samples of the surface -> [n, 3] float32."""
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    total = areas.sum()
    probs = areas / total if total > 0 else np.full(len(areas), 1.0 / max(len(areas), 1))
    rng = np.random.default_rng(seed)
    fidx = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    tri = verts[faces[fidx]]
    return ((1 - r1)[:, None] * tri[:, 0] + (r1 * (1 - r2))[:, None] * tri[:, 1]
            + (r1 * r2)[:, None] * tri[:, 2]).astype(np.float32)


@torch.inference_mode()
def crops_and_renders(frames: np.ndarray, poses: np.ndarray, mesh, k: torch.Tensor, device, chunk: int = 8):
    """frames [T, H, W, 3] uint8 (host), poses [T, 4, 4], mesh (vertices,
    faces, colours) as numpy at the object's scale -> (photo crops [T, 3,
    RES, RES], renders [T, 3, RES, RES], render masks on the patch grid [T,
    GRID, GRID] bool)."""
    verts, faces, colors = mesh
    pts = torch.as_tensor(sample_surface(verts, faces, SURFACE_POINTS, SURFACE_SEED), device=device)
    v = torch.as_tensor(verts, dtype=torch.float32, device=device)
    c = torch.as_tensor(colors, dtype=torch.float32, device=device)
    f = torch.as_tensor(faces, dtype=torch.int64, device=device)
    valid = torch.ones(f.shape[0], dtype=torch.bool, device=device)
    crops, renders, masks = [], [], []
    for i in range(0, len(poses), chunk):
        p = torch.as_tensor(poses[i:i + chunk], dtype=torch.float32, device=device)
        imgs = torch.as_tensor(frames[i:i + chunk], device=device).float().div(255.0).permute(0, 3, 1, 2)
        boxes = crop_bbox_around_projection(p, pts, k, RES, RES, lamb=1.4)
        crops.append(torch.cat([roi_align(img, bb[None], RES, RES, sampling_ratio=2) for img, bb in zip(imgs, boxes)]))
        rgb, depth = render_meshes(v, c, f, valid, p, update_k_with_crop(k, boxes, RES, RES), SETTINGS)
        renders.append(rgb.permute(0, 3, 1, 2))
        masks.append(resize_area((depth > 0).float(), (GRID, GRID)) > 0.5)
    return torch.cat(crops), torch.cat(renders), torch.cat(masks)


def confidences(vit, crops: torch.Tensor, renders: torch.Tensor, masks: torch.Tensor, batch: int = 16):
    """[T, GRID, GRID]: the patch cosine of each photo crop with its render,
    nought off the render's mask."""
    out = []
    for i in range(0, crops.shape[0], batch):
        f = models.patch_features(vit, torch.cat([crops[i:i + batch], renders[i:i + batch]]), None)
        b = f.shape[0] // 2
        out.append((f[:b] * f[b:]).sum(dim=-1).reshape(b, GRID, GRID) * masks[i:i + batch])
    return torch.cat(out)


def threshold(conf: torch.Tensor) -> float:
    """The cosine that keeps the top fifth of the positive ones: the
    descending sort of the positives read at int(0.2 · their count)."""
    pos = conf.reshape(-1)
    pos = pos[pos > 0].sort(descending=True).values
    if pos.numel() == 0:
        return 0.0
    n = torch.tensor(float(pos.numel()), dtype=torch.float32)
    return float(pos[int((n * TOP_QUANTILE).to(torch.int32))])


def rank_err(conf: torch.Tensor, thr: float) -> float:
    """How far a threshold lies from the top fifth of the positive cosines:
    |the positives above it - int(0.2 · their count)| over their count."""
    pos = conf.reshape(-1)
    pos = pos[pos > 0]
    if pos.numel() == 0:
        return 0.0
    n = torch.tensor(float(pos.numel()), dtype=torch.float32)
    return abs(int((pos > thr).sum()) - int((n * TOP_QUANTILE).to(torch.int32))) / pos.numel()


def count_gap(conf: torch.Tensor, thr: float, counts) -> float:
    """The largest distance from the threshold of a cosine whose side of it
    a frame's count must have decided otherwise: a frame that counts c
    where the reference counts r takes in (c > r) or leaves out (c < r) the
    cosines ranked r+1..c or c+1..r, the farthest of which is read."""
    s = conf.reshape(conf.shape[0], -1).sort(dim=1, descending=True).values
    gap = 0.0
    for t, c in enumerate(np.asarray(counts, np.int64)):
        r = int((s[t] > thr).sum())
        if c > r:
            gap = max(gap, thr - float(s[t, min(int(c), s.shape[1]) - 1]))
        elif c < r:
            gap = max(gap, float(s[t, int(c)]) - thr)
    return gap
