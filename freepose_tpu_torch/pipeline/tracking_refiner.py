"""Render-and-compare track refinement: pose confidence, 2D-3D
correspondences, point tracking, PnP.

Counterpart of freepose_tpu.pipeline.tracking_refiner:

  * pose confidence: the DINOv2-B patch cosine between the photo crop and a
    render of the mesh at the pose, masked by the render's 37 x 37 coverage;
    the crop is an ROI-align around the projected model points and the
    render uses the crop's intrinsics;
  * inlier counts against a threshold on the top fifth of the positive
    confidences;
  * 2D-3D correspondences: surface samples projected into the 37 x 37 patch
    grid, per visible patch the sample nearest the patch centre (in coarse
    bins) and then nearest the camera;
  * point tracking, EPnP and the resample heuristic.

On the card the renders run through kernel K1 (ops/rasterizer.py) and
DINOv2-B through K2; EPnP runs on the host CPU in float32, as in the JAX
package. `StreamingInliers` scores a staged video's confidence chunks as
the refine loop finalises their poses. Over a device mesh
(parallel/mesh.py) the confidence frames and the correspondence starts
split over an axis, each shard on its own device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freepose_tpu_torch.geometry.camera import crop_bbox_around_projection, update_k_with_crop
from freepose_tpu_torch.io.mesh import TriMesh, pad_mesh
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize
from freepose_tpu_torch.ops.sampling import resize_area, roi_align
from freepose_tpu_torch.parallel.mesh import gather, replicate, split
from freepose_tpu_torch.pipeline.pnp import epnp
from freepose_tpu_torch.pipeline.template_bank import normalize_feats
from freepose_tpu_torch.utils import timing

RES = 518  # DINOv2-B input -> 37 x 37 patches
PATCH = 14
GRID = RES // PATCH  # 37


def confidence_map(photo_feats: torch.Tensor, render_feats: torch.Tensor, render_mask37: torch.Tensor) -> torch.Tensor:
    """[G², D] x 2 (normalized) + [G, G] bool -> [G, G] cosine confidence."""
    return (photo_feats * render_feats).sum(dim=-1).reshape(GRID, GRID) * render_mask37


def quantile_threshold(conf: torch.Tensor, top_quantile: float = 0.2) -> torch.Tensor:
    """The threshold that keeps the top `top_quantile` of the positive
    confidences: the descending sort of the positives (the rest at -1e9) read
    at int(top_quantile · n_pos), the product taken in float32 and
    truncated, as in the JAX function."""
    flat = torch.as_tensor(conf, dtype=torch.float32).reshape(-1)
    pos = flat > 0
    order = torch.where(pos, flat, torch.tensor(-1e9, dtype=torch.float32, device=flat.device)).sort(
        descending=True).values
    n_pos = pos.sum().to(torch.float32)
    idx = (n_pos * top_quantile).to(torch.int32).clamp(0, flat.shape[0] - 1)
    return order[idx]


def _bin_surface_to_patches(surf, pose, new_k, mask37, bbox):
    """Project surface samples [N, 3] into the 37 x 37 crop grid and pick
    per patch the sample of the smallest key (centre-distance bin · 100 +
    depth); ties go to the lower sample index (a stable sort, then a
    scatter-min of sorted positions). -> (query [G², 2] full-image pixels at
    the patch centres, surface points [G², 3], valid [G²])."""
    n = surf.shape[0]
    dev = surf.device
    cam = surf @ pose[:3, :3].T + pose[:3, 3]
    uvw = cam @ new_k.T
    uv = uvw[:, :2] / torch.clamp(uvw[:, 2:3], min=1e-6)
    patch_f = torch.floor(uv / PATCH)
    patch_xy = patch_f.to(torch.int32)
    in_grid = ((patch_xy[:, 0] >= 0) & (patch_xy[:, 0] < GRID) & (patch_xy[:, 1] >= 0) & (patch_xy[:, 1] < GRID)
               & (cam[:, 2] > 1e-4))
    pid = torch.where(in_grid, patch_xy[:, 1] * GRID + patch_xy[:, 0], GRID * GRID).long()
    center_off = uv / PATCH - patch_f - 0.5
    cdist = (center_off * center_off).sum(dim=-1)
    cbin = torch.clamp((cdist * 16).to(torch.int32), 0, 15).to(torch.float32)
    key = cbin * 100.0 + torch.clamp(cam[:, 2], 0.0, 99.0)
    key = torch.where(in_grid, key, torch.inf)
    order = torch.argsort(key, stable=True)
    positions = torch.arange(n, dtype=torch.int64, device=dev)
    seg_min = torch.full((GRID * GRID + 1,), n, dtype=torch.int64, device=dev)
    seg_min = seg_min.scatter_reduce(0, pid[order], positions, reduce="amin")[: GRID * GRID]
    has_point = seg_min < n
    surface_points = surf[order[seg_min.clamp(max=n - 1)]]
    valid = has_point & mask37.reshape(-1)
    g = torch.arange(GRID * GRID, device=dev)
    pts_crop = torch.stack([g % GRID, g // GRID], dim=-1).to(torch.float32) * PATCH + PATCH * 0.5
    x1, y1, x2, y2 = bbox
    query = pts_crop / RES * torch.stack([x2 - x1, y2 - y1]) + torch.stack([x1, y1])
    return query, surface_points, valid


def _mask37(depth: torch.Tensor) -> torch.Tensor:
    return resize_area((depth > 0).to(torch.float32), (GRID, GRID)) > 0.5


def _correspondences(v, c, f, fv, pts100, surf, k, pose, mask, settings):
    """Crop box, the shrunk mesh's render at the crop's intrinsics, its
    37 x 37 coverage (and'ed with the cropped object mask where that keeps at
    least 4 patches), then the patch binning."""
    bbox = crop_bbox_around_projection(pose[None], pts100, k, RES, RES, lamb=1.4)[0]
    new_k = update_k_with_crop(k, bbox[None], RES, RES)[0]
    _, depth = rasterize(v, c, f, fv, pose[None], new_k, settings)
    mask37 = _mask37(depth[0])
    if mask is not None:
        crop_mask = roi_align(mask[None], bbox[None], RES, RES)[0, 0]
        combined = mask37 & (resize_area(crop_mask, (GRID, GRID)) > 0.5)
        mask37 = torch.where(combined.sum() >= 4, combined, mask37)
    return _bin_surface_to_patches(surf, pose, new_k, mask37, bbox)


def _frames_float(frames, device) -> torch.Tensor:
    """uint8 frames move to `device` as they are and are normalised there."""
    frames = torch.as_tensor(frames).to(device)
    return frames.to(torch.float32) / 255.0 if frames.dtype == torch.uint8 else frames.to(torch.float32)


def _confidence_block(v, c, f, valid, pts, k, frames, poses, patch_feats, settings, channels_last=False):
    """[B] photos (uint8 or float, on any device) and poses -> [B, 37, 37]
    confidence on the poses' device: crops around the projected model
    points, renders at the crops' intrinsics, one feature batch of both
    (`patch_feats` -> L2-normalized fp32 [2B, G², D]), the masked patch
    cosine."""
    frames = _frames_float(frames, poses.device)
    if channels_last:
        frames = frames.permute(0, 3, 1, 2)
    bboxes = crop_bbox_around_projection(poses, pts, k, RES, RES, lamb=1.4)
    crops = torch.cat([roi_align(img, bb[None], RES, RES, sampling_ratio=2) for img, bb in zip(frames, bboxes)])
    render_rgb, render_depth = rasterize(v, c, f, valid, poses, update_k_with_crop(k, bboxes, RES, RES), settings)
    b = frames.shape[0]
    feats = patch_feats(torch.cat([crops, render_rgb.permute(0, 3, 1, 2)]))
    return (feats[:b] * feats[b:]).sum(dim=-1).reshape(b, GRID, GRID) * _mask37(render_depth)


def _correspondences_batch(v, c, f, fv, pts100, surf, k, poses, settings):
    """One render of every start pose [I] (K1 on the card), then the patch
    binning per start -> ([I, G², 2], [I, G², 3], [I, G²])."""
    bboxes = crop_bbox_around_projection(poses, pts100, k, RES, RES, lamb=1.4)
    new_ks = update_k_with_crop(k, bboxes, RES, RES)
    _, depths = rasterize(v, c, f, fv, poses, new_ks, settings)
    outs = [_bin_surface_to_patches(surf, *args) for args in zip(poses, new_ks, _mask37(depths), bboxes)]
    return tuple(torch.stack(x) for x in zip(*outs))


def _epnp_batch(object_pts, image_pts, k, valid):
    """EPnP for every frame: [N, 3], [T, N, 2], [3, 3], [T, N] -> [T, 4, 4]."""
    return epnp(object_pts, image_pts, k, valid)


@dataclasses.dataclass
class TrackingRefiner:
    """feature_fn: the DINOv2-B patch extractor, [B, 3, 518, 518] in [0, 1]
    -> [B, 37², D]; tracker: PointTracker or CoTracker2Predictor. Device
    tensors live on `device`. `extractor` (the DinoFeatureExtractor behind
    feature_fn, run to `feature_layer`) is what the sharded confidence
    replicates on each device of a mesh."""

    feature_fn: object
    tracker: object
    max_vertices: int = 8192
    max_faces: int = 16384
    n_surface_samples: int = 10000
    settings: RasterSettings = dataclasses.field(
        default_factory=lambda: RasterSettings(resolution=RES, tile=37, max_faces_per_tile=256))
    device: str | torch.device | None = None
    extractor: object = None
    feature_layer: int | None = None

    def __post_init__(self):
        from freepose_tpu_torch.device import resolve_device

        self.device = resolve_device(self.device)
        self._pad_cache: dict = {}

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        with timing.wait("inliers.inputs"):  # an upload from pageable memory synchronises
            return torch.as_tensor(x).to(self.device, dtype)

    def _crop_and_k(self, image: torch.Tensor, mesh_pts: torch.Tensor, k: torch.Tensor, pose: torch.Tensor):
        """The photo crop around the projected model and its intrinsics."""
        bbox = crop_bbox_around_projection(pose[None], mesh_pts, k, RES, RES, lamb=1.4)[0]
        crop = roi_align(image, bbox[None], RES, RES, sampling_ratio=2)[0]
        return crop, bbox, update_k_with_crop(k, bbox[None], RES, RES)[0]

    def _padded(self, mesh: TriMesh, scale: float = 1.0):
        """pad_mesh's arrays on the device, cached per (mesh object, scale)
        for the last 8 meshes; the entry holds the mesh itself, so a
        recycled id() never aliases."""
        key = (id(mesh), scale)
        entry = self._pad_cache.get(key)
        if entry is None or entry[0] is not mesh:
            v, c, f, valid = pad_mesh(mesh, self.max_vertices, self.max_faces)
            entry = (mesh, (self._t(v * scale), self._t(c), self._t(f, torch.int32), self._t(valid, torch.bool)))
            self._pad_cache[key] = entry
            while len(self._pad_cache) > 8:
                self._pad_cache.pop(next(iter(self._pad_cache)))
        return entry[1]

    def _render(self, mesh: TriMesh, k: torch.Tensor, pose: torch.Tensor, scale: float = 1.0):
        v, c, f, valid = self._padded(mesh, scale)
        rgb, depth = rasterize(v, c, f, valid, pose[None], k, self.settings)
        return rgb[0], depth[0]

    def _patch_feats(self, images: torch.Tensor) -> torch.Tensor:
        """[B, 3, RES, RES] -> [B, G², D] L2-normalized float32 patch features."""
        return normalize_feats(self.feature_fn(images).to(torch.float32))

    # ---------------------------------------------------------------- #
    @torch.inference_mode()
    def pose_confidence(self, mesh: TriMesh, photo, k, pose) -> np.ndarray:
        """[3, H, W] photo (float in [0, 1] or uint8) -> [37, 37] confidence."""
        photo, k, pose = _frames_float(photo, self.device), self._t(k), self._t(pose)
        pts = self._t(mesh.sample_surface(100, seed=42))
        crop, _, new_k = self._crop_and_k(photo, pts, k, pose)
        render_rgb, render_depth = self._render(mesh, new_k, pose)
        feats = self._patch_feats(torch.stack([crop, render_rgb.permute(2, 0, 1)]))
        return confidence_map(feats[0], feats[1], _mask37(render_depth)).cpu().numpy()

    @torch.inference_mode()
    def pose_confidence_batch(self, mesh: TriMesh, frames, k, poses, fetch: bool = True,
                              channels_last: bool = False):
        """[B, 3, H, W] photos (or [B, H, W, 3] with channels_last) + [B, 4, 4]
        poses -> [B, 37, 37]: one crop / render / feature batch. fetch=False
        keeps the result on the device."""
        out = _confidence_block(*self._padded(mesh), self._t(mesh.sample_surface(100, seed=42)), self._t(k),
                                frames, self._t(poses), self._patch_feats, self.settings, channels_last)
        return out.cpu().numpy() if fetch else out

    @torch.inference_mode()
    def pose_confidence_batch_sharded(self, mesh: TriMesh, frames, k, poses, device_mesh, axis: str = "data",
                                      fetch: bool = True, channels_last: bool = False):
        """pose_confidence_batch with the frame batch split over a device
        mesh axis: each shard crops, renders and featurizes B / axis-size
        frames on its device (the extractor replicated there), and the maps
        are gathered on the mesh's first device. Needs `extractor`."""
        if self.extractor is None:
            raise ValueError("sharded confidence requires `extractor`")
        if frames.shape[0] % device_mesh.shape[axis]:
            raise ValueError(
                f"batch {frames.shape[0]} must divide over the '{axis}' axis ({device_mesh.shape[axis]} devices)")
        bufs = replicate((*self._padded(mesh), self._t(mesh.sample_surface(100, seed=42)), self._t(k)), device_mesh)
        extractors = replicate(self.extractor, device_mesh)

        def feats_on(dev):
            fe = extractors[dev]
            return lambda images: normalize_feats(fe(images, layer=self.feature_layer, feature_type="patch").float())

        parts = [
            _confidence_block(*bufs[po.device], fr, po, feats_on(po.device), self.settings, channels_last)
            for fr, po in zip(split(torch.as_tensor(frames), device_mesh, axis),
                              split(self._t(poses), device_mesh, axis))
        ]
        out = gather(parts, device_mesh)
        return out.cpu().numpy() if fetch else out

    @torch.inference_mode()
    def correspondences_batch(self, mesh: TriMesh, k, poses, seed: int = 0, device_mesh=None, axis: str = "data"):
        """compute_2d3d_correspondences for a batch of interval-start poses
        [I, 4, 4]: one render of every start (K1 on the card), then the patch
        binning per start -> ([I, G², 2] query pixels, [I, G², 3] surface
        points, [I, G²] valid) on the device. With `device_mesh` the starts
        split over `axis`, each shard rendering and binning its own, and the
        results are gathered on the mesh's first device."""
        pts100 = self._t(mesh.sample_surface(100, seed=42))
        surf = self._t(mesh.sample_surface(self.n_surface_samples, seed=seed))
        args = (*self._padded(mesh, 0.8), pts100, surf, self._t(k))
        poses = self._t(poses)
        if device_mesh is None:
            return _correspondences_batch(*args, poses, self.settings)
        if poses.shape[0] % device_mesh.shape[axis]:
            raise ValueError(f"interval batch {poses.shape[0]} must divide over the '{axis}' axis "
                             f"({device_mesh.shape[axis]} devices)")
        bufs = replicate(args, device_mesh)
        return gather([_correspondences_batch(*bufs[po.device], po, self.settings)
                       for po in split(poses, device_mesh, axis)], device_mesh)

    def n_inliers_per_pose(self, mesh: TriMesh, frames, k, poses, chunk: int = 8, channels_last: bool = False,
                           device_mesh=None, mesh_axis: str = "data"):
        """Confidence and inlier count of every frame -> (inliers [T] int,
        threshold). `frames` is [T, 3, H, W] on the host, or with
        channels_last the device-resident [T, H, W, 3] uint8 video, sliced on
        the device. Chunks of `chunk` frames; the tail chunk repeats its last
        frame and pose (the rows past the video are dropped). With
        `device_mesh` each chunk's frames split over `mesh_axis`
        (pose_confidence_batch_sharded)."""
        n = len(frames)
        poses = np.asarray(poses)
        outs = []
        for i in range(0, n, chunk):
            idx = np.minimum(np.arange(i, i + chunk), n - 1)
            part = frames[torch.as_tensor(idx, device=frames.device)] if torch.is_tensor(frames) else frames[idx]
            if device_mesh is not None:
                outs.append(self.pose_confidence_batch_sharded(mesh, part, k, poses[idx], device_mesh, mesh_axis,
                                                               fetch=False, channels_last=channels_last))
            else:
                outs.append(self.pose_confidence_batch(mesh, part, k, poses[idx], fetch=False,
                                                       channels_last=channels_last))
        with timing.wait("inliers.result"):
            confs = torch.cat(outs)[:n].cpu()
        thr = float(quantile_threshold(confs))
        return (confs > thr).sum(dim=(1, 2)).numpy(), thr

    # ---------------------------------------------------------------- #
    @torch.inference_mode()
    def compute_2d3d_correspondences(self, mesh: TriMesh, photo, k, pose, mask=None, seed: int = 0,
                                     fetch: bool = True):
        """-> (query points [G², 2] full-image pixels, surface points [G², 3]
        object frame, valid [G²]), on the 37² patch grid. The photo's pixels
        are never read (the parameter keeps the reference's interface).
        fetch=False keeps the results on the device."""
        pts100 = self._t(mesh.sample_surface(100, seed=42))
        surf = self._t(mesh.sample_surface(self.n_surface_samples, seed=seed))
        v, c, f, fv = self._padded(mesh, 0.8)  # the reference's 0.8 shrink
        out = _correspondences(v, c, f, fv, pts100, surf, self._t(k), self._t(pose),
                               None if mask is None else self._t(mask), self.settings)
        return out if not fetch else tuple(x.cpu().numpy() for x in out)

    def track_frames(self, frames, query_points, query_frame: int = 0):
        """frames [T, H, W, 3]; queries [N, 2] -> (tracks [T, N, 2], vis [T, N])."""
        return self.tracker.track(frames, query_points, query_frame)

    @staticmethod
    def compute_pnp(image_pts, object_pts, valid, k) -> np.ndarray:
        """EPnP on the host CPU in float32 -> [4, 4]."""
        return TrackingRefiner.compute_pnp_batch(np.asarray(image_pts)[None], object_pts,
                                                 np.asarray(valid)[None], k)[0]

    @staticmethod
    def compute_pnp_batch(image_pts, object_pts, valid, k) -> np.ndarray:
        """EPnP for every frame of an interval in one call on the host CPU:
        image_pts [T, N, 2], object_pts [N, 3], valid [T, N] -> [T, 4, 4]."""
        def host(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x)).to(dtype)

        with torch.inference_mode():
            return _epnp_batch(host(object_pts), host(image_pts), host(k), host(valid, torch.bool)).numpy()

    def compute_pnp_or_need_resample(self, mesh: TriMesh, photo, tracks: np.ndarray, visibility: np.ndarray,
                                     object_pts: np.ndarray, valid: np.ndarray, k):
        """PnP from the visible tracked points; resample when the
        correspondences generated at that pose have drifted from them."""
        vis_valid = valid & visibility
        if vis_valid.sum() < 0.5 * max(valid.sum(), 1):
            return True, None
        pose = self.compute_pnp(tracks, object_pts, vis_valid, k)
        new_query, _, new_valid = self.compute_2d3d_correspondences(mesh, photo, k, pose)
        old_pts, new_pts = tracks[vis_valid], new_query[new_valid]
        if len(new_pts) == 0 or len(old_pts) == 0:
            return True, pose
        d_old = np.sqrt(((new_pts[:, None] - old_pts[None]) ** 2).sum(-1)).min(1)
        d_new = np.zeros(len(new_pts))
        for i in range(len(new_pts)):
            others = np.delete(new_pts, i, axis=0)
            if len(others):
                d_new[i] = np.sqrt(((new_pts[i] - others) ** 2).sum(-1)).min()
        return bool(np.median(d_old) > np.median(d_new)), pose

    @staticmethod
    def get_query_frames(n_inliers: np.ndarray, n_reference: int = 8) -> np.ndarray:
        """Peak-pick reference frames, suppressing a span around each pick."""
        arr = n_inliers.astype(np.float64).copy()
        span = max(int(len(arr) / n_reference / 2), 1)
        chosen = []
        while len(chosen) < min(n_reference, len(arr)):
            idx = int(np.argmax(arr))
            chosen.append(idx)
            arr[max(idx - span, 0): idx + span + 1] = -1
        return np.sort(np.asarray(chosen))


class StreamingInliers:
    """n_inliers_per_pose fed pose by pose over a video staged on the device
    (datasets/video.py:StagedVideo). Each frame's confidence depends only on
    that frame's pose, so a chunk of `chunk` frames is dispatched as soon as
    all its poses are known: the confidence work runs behind the refine loop
    that produces the poses instead of after it. `add(t, pose)` takes poses
    in any order; `finalize()` returns (inliers [n], threshold), equal to
    n_inliers_per_pose on the same poses. Each chunk's result is copied to
    pinned host memory behind its own work (fine_cache.HostCopy), so no
    chunk waits for the card; `finalize` waits once."""

    def __init__(self, refiner: TrackingRefiner, mesh: TriMesh, staged, k, chunk: int = 8):
        from freepose_tpu_torch.datasets.video import StagedVideo

        if not isinstance(staged, StagedVideo):
            raise TypeError("StreamingInliers requires a StagedVideo (datasets/video.py:stage_frames_hbm)")
        if staged.frames.shape[0] % chunk:
            raise ValueError("staged bucket must be a multiple of chunk")
        self.refiner = refiner
        self.mesh = mesh
        self.staged = staged
        self.k = refiner._t(k)
        self.chunk = chunk
        self.n = staged.n
        self._poses: dict[int, np.ndarray] = {}
        self._outs: list = []  # per chunk, a HostCopy of [chunk, 37, 37]
        self._next = 0  # first frame of the next chunk to dispatch

    def _dispatch(self, start: int, poses: np.ndarray):
        from freepose_tpu_torch.pipeline.fine_cache import HostCopy

        frames = self.staged.frames[start:start + self.chunk]
        return HostCopy(self.refiner.pose_confidence_batch(self.mesh, frames, self.k, poses, fetch=False,
                                                           channels_last=True), "inliers")

    def warmup(self) -> None:
        """One chunk on identity poses before any timed region (the result
        is dropped)."""
        if self._next == 0 and not self._outs:
            self._dispatch(0, np.tile(np.eye(4, dtype=np.float32), (self.chunk, 1, 1))).numpy()

    def add(self, t: int, pose) -> None:
        self._poses[t] = np.asarray(pose, np.float32)
        self._flush()

    def _flush(self) -> None:
        while self._next < self.n:
            i = self._next
            hi = min(i + self.chunk, self.n)
            if any(j not in self._poses for j in range(i, hi)):
                return
            # A tail chunk repeats its last pose (those rows are dropped);
            # the staged buffer already repeats the last frame.
            with timing.span("inliers.dispatch"):
                poses = np.stack([self._poses[min(j, hi - 1)] for j in range(i, i + self.chunk)])
                self._outs.append(self._dispatch(i, poses))
            timing.count("inliers.frames", hi - i)
            self._next = hi

    def finalize(self):
        """-> (inliers [n] int, threshold float). Every pose must be fed."""
        if self._next < self.n:
            missing = [j for j in range(self._next, self.n) if j not in self._poses]
            raise ValueError(f"StreamingInliers: poses missing for frames {missing[:5]}")
        with timing.span("inliers.finalize"):
            confs = np.concatenate([o.numpy()[: self.n - i]
                                    for i, o in zip(range(0, self.n, self.chunk), self._outs)])
            # Padded with -1e9 to the staged bucket, as the JAX function pads;
            # the threshold reads positive confidences only.
            padded = np.full((self.staged.frames.shape[0], *confs.shape[1:]), -1e9, np.float32)
            padded[: self.n] = confs
            thr = float(quantile_threshold(torch.as_tensor(padded)))
            return (confs > thr).sum(axis=(1, 2)), thr
