"""Online (per-frame) fine pose refinement by local re-render and re-score.

Counterpart of freepose_tpu.pipeline.online_pose_estimator: frame 0 runs the
coarse 600-view estimator; later frames take the `n_neighbors` poses of a
dense super-Fibonacci grid (10-20k poses) nearest to the previous pose,
masked to its geodesic ball (15° by default), re-render the mesh at those
poses (kernel K1 on the card), featurize the renders (DINOv2, kernel K2 on
the card), rescore them against the query crop and z-lift the winner.

With a fine-view cache (pipeline/fine_cache.py) each grid pose's render,
features and pointcloud stats are computed once per track and reused while
the pose stays in the neighbourhood; `AutoRefineChain` pipelines the frames
of a track with all of the cache's bookkeeping on the device.
With a device mesh (parallel/mesh.py) the neighbourhood's renders and
feature batch split over its "model" axis (`refine_sharded`), or, with the
cache, each miss batch's do.

The JAX package compiles each step into one program; here a step is a plain
function of PyTorch calls. Neighbourhood selection and the final argmax keep
the lowest index among equal values, as lax.top_k does (a stable sort, and
torch.argmax's first maximum), and view scores are fp32 whatever the
features' dtype.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from freepose_tpu_torch.geometry.rotation import geodesic_distance, template_poses
from freepose_tpu_torch.ops.rasterizer import render_meshes
from freepose_tpu_torch.ops.sampling import resize_area
from freepose_tpu_torch.parallel.mesh import canonical_device, gather, make_mesh, replicate, split
from freepose_tpu_torch.pipeline.pose_estimator import CoarsePoseEstimator, PoseEstimate
from freepose_tpu_torch.pipeline.renderer import (
    DEGENERATE_MASK_MIN_PX,
    RENDERING_SCALE,
    TemplateRenderer,
    generate_proposals,
    zoom_intrinsics_for_poses,
)
from freepose_tpu_torch.pipeline.template_bank import depth_stats, depth_stats_per_k, normalize_feats
from freepose_tpu_torch.utils import timing


def select_neighborhood(
    fine_poses: torch.Tensor,  # [N, 4, 4] pose grid
    prev_pose: torch.Tensor,  # [4, 4]
    neighborhood_deg: float,
    n_neighbors: int,
):
    """The `n_neighbors` grid poses nearest to prev_pose, nearest first
    (equal distances: lowest index first), and the within-threshold mask
    (index 0 always kept) -> (poses [n, 4, 4], indices [n], mask [n])."""
    dists = geodesic_distance(fine_poses[:, :3, :3], prev_pose[:3, :3])
    idx = torch.argsort(dists, stable=True)[:n_neighbors]
    mask = dists[idx] < neighborhood_deg
    with timing.wait("refine.neighborhood"):  # writing a host scalar synchronises
        mask[0] = True
    return fine_poses[idx], idx, mask


def rescore_views(
    render_feats: torch.Tensor,  # [R, G², D] normalized patch feats of renders
    query_feat: torch.Tensor,  # [G², D] normalized
    view_valid: torch.Tensor,  # [R] bool (neighbourhood mask)
    render_masks: torch.Tensor,  # [R, H, W] bool render masks
    proposal_mask: torch.Tensor,  # [H, W] bool query proposal mask
    grid: int,
    use_mask: bool,
) -> torch.Tensor:
    """Mean patch cosine per view, optionally weighted by the union of the
    render's and the proposal's masks at the patch grid; -inf outside the
    neighbourhood. The products run in fp32 whatever the features' dtype
    (the JAX function asks for an fp32 result of its bf16 einsum)."""
    per_patch = (render_feats.float() * query_feat.float()[None]).sum(dim=-1)  # [R, G²]
    if use_mask:
        union = (render_masks | proposal_mask[None]).to(torch.float32)
        w = resize_area(union, (grid, grid)).reshape(render_feats.shape[0], grid * grid)
        scores = (per_patch * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1e-6)
    else:
        scores = per_patch.mean(dim=-1)
    return torch.where(view_valid, scores, -torch.inf)


def score_and_lift_from_stats(scores, pc_min, pc_max, pc_mean, poses, k, bbox, est_scale,
                              rendering_scale: float):
    """Argmax (first maximum) + bbox z-lift from per-view scores [R] and
    cloud stats [R, 3] -> (tcos [1, 4, 4], score [1], local index [])."""
    top_idx = torch.argmax(scores).reshape(1)
    top_score = scores[top_idx]
    s = est_scale / rendering_scale
    mean = pc_mean[top_idx]
    mins = (pc_min[top_idx] - mean) * s + mean
    maxs = (pc_max[top_idx] - mean) * s + mean
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    bb_dx = (bbox[2] - bbox[0]) + 1.0
    bb_dy = (bbox[3] - bbox[1]) + 1.0
    z = (fx * (maxs[:, 0] - mins[:, 0]) / bb_dx + fy * (maxs[:, 1] - mins[:, 1]) / bb_dy) / 2.0
    x = ((bbox[0] + bbox[2]) / 2.0 - cx) * z / fx
    y = ((bbox[1] + bbox[3]) / 2.0 - cy) * z / fy
    tcos = poses[top_idx].clone()
    tcos[:, 0, 3] = x
    tcos[:, 1, 3] = y
    tcos[:, 2, 3] = z
    return tcos, top_score, top_idx[0]


def render_view_block(v, c, f, fv, poses, k_render, settings, pose_chunk, resolution, zoom):
    """Render fine views -> (props [P, 3, R, R], masks [P, R, R], (min, max,
    mean) cloud stats). zoom=False renders the full-frame template camera
    and crops each render around its mask; zoom=True renders each pose
    under its zoomed intrinsics (zoom_intrinsics_for_poses), so the render is
    the proposal at native resolution, and the cloud stats use each view's
    K (the same 3D quantities either way)."""
    if not zoom:
        rgb, depth = render_meshes(v, c, f, fv, poses, k_render, settings, pose_chunk=pose_chunk)
        props, masks, _ = generate_proposals(rgb, depth, resolution, resolution)
        return props, masks, depth_stats(depth, k_render)
    kz = zoom_intrinsics_for_poses(v, f, fv, poses, k_render, resolution)
    rgb, depth = render_meshes(v, c, f, fv, poses, kz, settings, pose_chunk=pose_chunk)
    masks = depth > 0
    q = resolution // 4
    fallback = torch.zeros((resolution, resolution), dtype=torch.bool, device=depth.device)
    fallback[q : resolution - q, q : resolution - q] = True
    small = masks.sum(dim=(1, 2)) < DEGENERATE_MASK_MIN_PX
    masks = torch.where(small[:, None, None], fallback[None], masks)
    return rgb.permute(0, 3, 1, 2), masks, depth_stats_per_k(depth, kz)


def _refine_prepare(fine_poses, prev_pose, neighborhood_deg, v, c, f, fv, k_render,
                    settings, n_neighbors, pose_chunk, resolution, zoom=False):
    """Neighbourhood + batched render + proposal crops + per-view cloud stats."""
    sel_poses, sel_idx, valid = select_neighborhood(fine_poses, prev_pose, neighborhood_deg, n_neighbors)
    props, render_masks, stats = render_view_block(
        v, c, f, fv, sel_poses, k_render, settings, pose_chunk, resolution, zoom
    )
    return sel_poses, sel_idx, valid, props, render_masks, stats


def _refine_prepare_fused(fine_poses, prev_pose, neighborhood_deg, v, c, f, fv, k_render,
                          settings, n_neighbors, pose_chunk, resolution, extractor, layer, zoom=False):
    """_refine_prepare + normalized DINOv2 patch features of the crops."""
    sel_poses, sel_idx, valid, props, render_masks, stats = _refine_prepare(
        fine_poses, prev_pose, neighborhood_deg, v, c, f, fv, k_render,
        settings, n_neighbors, pose_chunk, resolution, zoom,
    )
    feats = extractor(props, layer=layer, feature_type="patch")
    return sel_poses, sel_idx, valid, normalize_feats(feats), render_masks, stats


def _render_and_featurize(v, c, f, fv, k_render, poses, settings, pose_chunk, resolution, extractor, layer,
                          zoom):
    """One shard's block of fine views: render_view_block, then normalized
    patch features -> (feats, masks, min, max, mean), all on the poses'
    device."""
    props, masks, (smin, smax, smean) = render_view_block(
        v, c, f, fv, poses, k_render, settings, pose_chunk, resolution, zoom
    )
    feats = normalize_feats(extractor(props, layer=layer, feature_type="patch"))
    return feats, masks, smin, smax, smean


def shard_views(poses, v, c, f, fv, k_render, settings, pose_chunk, resolution, extractor, layer, device_mesh,
                axis, zoom=False):
    """Fine views [P] split over the mesh's `axis`: each shard renders and
    featurizes its block on its device, with the mesh buffers and the
    extractor replicated there (parallel/mesh.py:replicate); the blocks are
    gathered on mesh.first in shard order -> (feats [P, G², D], masks
    [P, R, R], (min, max, mean) [P, 3] each)."""
    bufs = replicate((v, c, f, fv, k_render), device_mesh)
    extractors = replicate(extractor, device_mesh)
    parts = [
        _render_and_featurize(*bufs[block.device], block, settings, pose_chunk, resolution,
                              extractors[block.device], layer, zoom)
        for block in split(poses, device_mesh, axis)
    ]
    feats, masks, smin, smax, smean = gather(parts, device_mesh)
    return feats, masks, (smin, smax, smean)


def _refine_prepare_fused_sharded(fine_poses, prev_pose, neighborhood_deg, v, c, f, fv, k_render, settings,
                                  n_neighbors, pose_chunk, resolution, extractor, layer, device_mesh, axis,
                                  zoom=False):
    """_refine_prepare_fused with the render and feature work split over
    `axis`: the neighbourhood is selected once on the estimator's device,
    its [n_neighbors] poses split across the shards (shard_views), and the
    blocks reassemble into the arrays the epilogue reads."""
    sel_poses, sel_idx, valid = select_neighborhood(fine_poses, prev_pose, neighborhood_deg, n_neighbors)
    feats, render_masks, stats = shard_views(sel_poses, v, c, f, fv, k_render, settings, pose_chunk, resolution,
                                             extractor, layer, device_mesh, axis, zoom)
    return sel_poses, sel_idx, valid, feats, render_masks, stats


def _refine_finish(render_feats, query_feat, valid, render_masks, proposal_mask, stats,
                   sel_poses, k, bbox, est_scale, grid, mask_scores, rendering_scale):
    """Masked rescoring + argmax + z-lift."""
    scores = rescore_views(render_feats, query_feat, valid, render_masks, proposal_mask, grid, mask_scores)
    pc_min, pc_max, pc_mean = stats
    return score_and_lift_from_stats(
        scores, pc_min, pc_max, pc_mean, sel_poses, k, bbox, est_scale, rendering_scale
    )


class OnlinePoseEstimator:
    def __init__(
        self,
        feature_fn,
        bank,
        renderer: TemplateRenderer | None = None,
        n_coarse_poses: int = 600,
        n_fine_poses: int = 10000,
        n_neighbors: int = 32,
        rendering_scale: float = RENDERING_SCALE,
        extractor=None,
        feature_layer: int = 22,
        fine_cache_capacity: int = 0,
        shard_mesh=None,
        zoom_renders: bool = False,
    ):
        """With `extractor` (a DinoFeatureExtractor), refine featurizes its
        renders through it at `feature_layer`; otherwise through
        `feature_fn`. `fine_cache_capacity` > 0 (needs `extractor`) caches
        each fine-grid view's features, mask and stats across the frames of
        a track (pipeline/fine_cache.py). `zoom_renders` renders fine views
        under per-pose zoomed intrinsics.

        `shard_mesh` (a parallel/mesh.py DeviceMesh whose first device is the
        renderer's; needs `extractor`) fans each frame's neighbour renders
        and feature batch over its "model" axis (refine_sharded). With the
        fine cache only each miss batch's renders and features shard; the
        cache stays on the mesh's first device
        (fine_cache.cached_refine_update)."""
        self.coarse = CoarsePoseEstimator(feature_fn, bank, n_poses=n_coarse_poses)
        self.feature_fn = feature_fn
        self.renderer = renderer or bank.renderer
        self.device = self.renderer.k.device
        self.fine_poses = template_poses(n_fine_poses, device=self.device)
        self.n_neighbors = n_neighbors
        self.rendering_scale = rendering_scale
        self.extractor = extractor
        self.feature_layer = feature_layer
        if fine_cache_capacity and extractor is None:
            raise ValueError("fine_cache_capacity requires `extractor`")
        if fine_cache_capacity and fine_cache_capacity < n_neighbors:
            raise ValueError(
                f"fine_cache_capacity ({fine_cache_capacity}) must hold at "
                f"least one neighbourhood (n_neighbors={n_neighbors})"
            )
        self.fine_cache_capacity = fine_cache_capacity
        if shard_mesh is not None and extractor is None:
            raise ValueError("shard_mesh requires `extractor`")
        if shard_mesh is not None and shard_mesh.first != canonical_device(self.device):
            raise ValueError(f"shard_mesh's first device {shard_mesh.first} is not the renderer's {self.device}")
        if shard_mesh is not None and fine_cache_capacity and n_neighbors % shard_mesh.shape["model"]:
            # Miss buckets must divide over the axis, and the largest is n_neighbors.
            raise ValueError(
                f"n_neighbors ({n_neighbors}) must divide evenly over the "
                f"'model' mesh axis ({shard_mesh.shape['model']} devices)"
            )
        self.shard_mesh = shard_mesh
        self.zoom_renders = zoom_renders
        # Extra views pre-cached per miss frame by rounding the miss batch up
        # a bucket, filled with prefetch ordered around the predicted next
        # pose, so the frames after a miss frame tend to be all-hit. 0 fills
        # only the natural bucket padding.
        self.prefetch_quota = 4
        self._fine_caches: dict = {}
        self._fine_rots_np = self.fine_poses[:, :3, :3].cpu().numpy()
        self._last_prev_rot: dict = {}
        self._padded_meshes: dict = {}

    def _f32(self, x) -> torch.Tensor:
        with timing.wait("refine.inputs"):  # an upload from pageable memory synchronises
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _index(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    def _padded_mesh(self, key, mesh):
        """Padded device mesh buffers, cached per track, so the mesh is not
        uploaded again on every frame."""
        entry = self._padded_meshes.get(key)
        if entry is None or entry[0] is not mesh:
            entry = (mesh, self.renderer._padded(mesh, self.rendering_scale))
            self._padded_meshes[key] = entry
        return entry[1]

    def estimate(self, proposal, proposal_mask, pack, mesh, k, bbox, est_scale: float,
                 prev_pose=None, neighborhood_deg: float = 15.0, mask_scores: bool = False,
                 cache_key=None) -> PoseEstimate:
        if prev_pose is None:
            coarse = self.coarse.estimate(proposal, pack, k, bbox, est_scale, return_query_feat=True)
            query_feat = coarse.query_feat
            prev_pose = coarse.tcos[0]
        else:
            query_feat = None  # the cached path featurizes the query itself
        if self.fine_cache_capacity:
            return self.refine_cached(
                proposal, proposal_mask, mesh, k, bbox, est_scale, prev_pose,
                neighborhood_deg, mask_scores,
                cache_key=cache_key if cache_key is not None else pack.name,
            )
        if query_feat is None:
            query_feat = self.coarse.query_features(proposal)
        if self.shard_mesh is not None:
            return self.refine_sharded(query_feat, proposal_mask, mesh, k, bbox, est_scale, prev_pose,
                                       device_mesh=self.shard_mesh, neighborhood_deg=neighborhood_deg,
                                       mask_scores=mask_scores)
        return self.refine(query_feat, proposal_mask, mesh, k, bbox, est_scale, prev_pose,
                           neighborhood_deg, mask_scores)

    def estimate_frame(self, objects: list[dict], neighborhood_deg: float = 15.0,
                       mask_scores: bool = False, fuse: bool = False) -> list[PoseEstimate]:
        """Per-frame refine of M co-tracked objects.

        Each entry of `objects` is a dict with keys `proposal` [3,R,R],
        `proposal_mask` [R,R], `pack`, `mesh`, `k`, `bbox`, `est_scale`,
        `prev_pose` (None -> coarse frame-0 path) and optional `cache_key`.

        fuse=False refines the objects one after another. fuse=True puts
        every cache-hit object's query crop into one ViT batch
        (fine_cache.cached_refine_hit_multi) and every cache-miss object's
        crop and renders into another (cached_refine_update_multi), with the
        same results. Requires the fine-view cache."""
        if not self.fine_cache_capacity:
            raise ValueError("estimate_frame requires fine_cache_capacity > 0")
        from freepose_tpu_torch.pipeline.fine_cache import cached_refine_hit_multi, cached_refine_update_multi

        results: list[PoseEstimate | None] = [None] * len(objects)

        def serial(o, key):
            return self.estimate(
                o["proposal"], o["proposal_mask"], o["pack"], o["mesh"], o["k"], o["bbox"],
                o["est_scale"], prev_pose=o.get("prev_pose"), neighborhood_deg=neighborhood_deg,
                mask_scores=mask_scores, cache_key=key,
            )

        def obj_key(o):
            key = o.get("cache_key")
            return key if key is not None else o["pack"].name

        if not fuse or len(objects) == 1:
            return [serial(o, obj_key(o)) for o in objects]

        hits: list[tuple] = []
        misses: list[tuple] = []
        seen_keys: set = set()
        res = self.renderer.resolution
        for pos, o in enumerate(objects):
            key = obj_key(o)
            # Two objects sharing a cache key (same mesh id) stay serial: a
            # later same-key miss could evict a classified object's slots
            # before the fused call runs.
            share = key in seen_keys
            seen_keys.add(key)
            if share or o.get("prev_pose") is None:
                results[pos] = serial(o, key)
                continue
            assert o["proposal"].shape[-1] == res, (
                f"cached refine needs the proposal crop at render resolution ({o['proposal'].shape[-1]} vs {res})"
            )
            cache, sel_idx, valid, near_extra, missing = self._cached_state(
                key, self._host_pose(o["prev_pose"]), neighborhood_deg
            )
            if missing:
                misses.append((pos, o, key, cache, sel_idx, valid, near_extra, missing))
            else:
                hits.append((pos, o, cache, sel_idx, valid))

        def stacked(entries, name):
            return torch.stack([self._f32(e[1][name]) for e in entries])

        common = dict(extractor=self.extractor, layer=self.feature_layer, resolution=res,
                      mask_scores=mask_scores, rendering_scale=self.rendering_scale)
        if len(misses) == 1 or self.shard_mesh is not None:
            # The fused multi-miss update takes no mesh: under sharding each
            # miss takes the sharded per-object step.
            for pos, o, key, cache, sel_idx, valid, near_extra, missing in misses:
                results[pos] = self._dispatch_cached(
                    key, cache, sel_idx, valid, near_extra, missing, o["proposal"], o["proposal_mask"],
                    o["mesh"], o["k"], o["bbox"], o["est_scale"], mask_scores,
                )
        elif misses:
            # Shared bucket: every miss object renders the same view count
            # (smaller-miss objects get extra prefetch; results unchanged).
            m_b = max(self._natural_bucket(mi[3], mi[7]) for mi in misses)
            plans = [self._plan_miss(mi[3], mi[7], mi[6], mi[4], m_b) for mi in misses]
            sel_arr = np.stack([mi[4] for mi in misses])
            tcos, scores, local, qf = cached_refine_update_multi(
                [mi[3] for mi in misses], self.fine_poses,
                self._index(np.stack([p[0] for p in plans])), self._index(np.stack([p[1] for p in plans])),
                [self._padded_mesh(mi[2], mi[1]["mesh"]) for mi in misses], self.renderer.k,
                torch.stack([torch.as_tensor(mi[1]["proposal"], device=self.device) for mi in misses]),
                self._index(np.stack([mi[3].gather_slots(mi[4]) for mi in misses])),
                torch.as_tensor(np.stack([mi[5] for mi in misses]), device=self.device),
                self._index(sel_arr),
                torch.stack([torch.as_tensor(mi[1]["proposal_mask"], device=self.device) for mi in misses]),
                stacked(misses, "k"), stacked(misses, "bbox"), stacked(misses, "est_scale"),
                settings=self.renderer.settings, pose_chunk=self.renderer.pose_chunk,
                zoom=self.zoom_renders, **common,
            )
            for j, mi in enumerate(misses):
                results[mi[0]] = PoseEstimate(tcos[j], scores[j], self._index(sel_arr[j])[local[j]], qf[j])

        if hits:
            sel_arr = np.stack([h[3] for h in hits])
            tcos, scores, local, qf = cached_refine_hit_multi(
                [h[2] for h in hits], self.fine_poses,
                torch.stack([torch.as_tensor(h[1]["proposal"], device=self.device) for h in hits]),
                self._index(np.stack([h[2].gather_slots(h[3]) for h in hits])),
                torch.as_tensor(np.stack([h[4] for h in hits]), device=self.device),
                self._index(sel_arr),
                torch.stack([torch.as_tensor(h[1]["proposal_mask"], device=self.device) for h in hits]),
                stacked(hits, "k"), stacked(hits, "bbox"), stacked(hits, "est_scale"),
                **common,
            )
            for j, h in enumerate(hits):
                results[h[0]] = PoseEstimate(tcos[j], scores[j], self._index(sel_arr[j])[local[j]], qf[j])
        return results

    def refine(self, query_feat, proposal_mask, mesh, k, bbox, est_scale: float, prev_pose,
               neighborhood_deg: float = 15.0, mask_scores: bool = False) -> PoseEstimate:
        """Uncached refine: select, render and featurize the whole
        neighbourhood, rescore, z-lift."""
        v, c, f, fv = self.renderer._padded(mesh, self.rendering_scale)
        prev_pose = self._f32(prev_pose)
        if self.extractor is not None:
            sel_poses, sel_idx, valid, render_feats, render_masks, stats = _refine_prepare_fused(
                self.fine_poses, prev_pose, neighborhood_deg, v, c, f, fv, self.renderer.k,
                self.renderer.settings, self.n_neighbors, self.renderer.pose_chunk,
                self.renderer.resolution, self.extractor, self.feature_layer, self.zoom_renders,
            )
        else:
            sel_poses, sel_idx, valid, props, render_masks, stats = _refine_prepare(
                self.fine_poses, prev_pose, neighborhood_deg, v, c, f, fv, self.renderer.k,
                self.renderer.settings, self.n_neighbors, self.renderer.pose_chunk,
                self.renderer.resolution, self.zoom_renders,
            )
            bs = 128
            feats = [self.feature_fn(props[i : i + bs]) for i in range(0, props.shape[0], bs)]
            render_feats = normalize_feats(torch.cat(feats))
        grid = int(round(render_feats.shape[1] ** 0.5))
        tcos, top_scores, local_idx = _refine_finish(
            render_feats, query_feat, valid, render_masks, torch.as_tensor(proposal_mask, device=self.device),
            stats, sel_poses, self._f32(k), self._f32(bbox), self._f32(est_scale), grid, mask_scores,
            self.rendering_scale,
        )
        return PoseEstimate(tcos, top_scores, sel_idx[local_idx], query_feat)

    def refine_sharded(self, query_feat, proposal_mask, mesh, k, bbox, est_scale: float, prev_pose,
                       device_mesh=None, axis: str = "model", neighborhood_deg: float = 15.0,
                       mask_scores: bool = False) -> PoseEstimate:
        """refine() with the per-frame hot work, the n_neighbors renders and
        their ViT batch, split over a device mesh axis: each shard renders
        and featurizes n_neighbors / axis-size views on its device, and the
        rescore and z-lift run on the gathered arrays on mesh.first. The
        same result as refine(). device_mesh=None: every CUDA card on
        "model"."""
        if self.extractor is None:
            raise ValueError("refine_sharded requires `extractor`")
        if device_mesh is None:
            device_mesh = make_mesh()
        n_dev = device_mesh.shape[axis]
        if self.n_neighbors % n_dev:
            raise ValueError(
                f"n_neighbors ({self.n_neighbors}) must divide evenly over "
                f"the '{axis}' mesh axis ({n_dev} devices)"
            )
        v, c, f, fv = self.renderer._padded(mesh, self.rendering_scale)
        sel_poses, sel_idx, valid, render_feats, render_masks, stats = _refine_prepare_fused_sharded(
            self.fine_poses, self._f32(prev_pose), neighborhood_deg, v, c, f, fv, self.renderer.k,
            self.renderer.settings, self.n_neighbors, self.renderer.pose_chunk, self.renderer.resolution,
            self.extractor, self.feature_layer, device_mesh, axis, self.zoom_renders,
        )
        grid = int(round(render_feats.shape[1] ** 0.5))
        tcos, top_scores, local_idx = _refine_finish(
            render_feats, query_feat, valid, render_masks, torch.as_tensor(proposal_mask, device=self.device),
            stats, sel_poses, self._f32(k), self._f32(bbox), self._f32(est_scale), grid, mask_scores,
            self.rendering_scale,
        )
        return PoseEstimate(tcos, top_scores, sel_idx[local_idx], query_feat)

    @staticmethod
    def _host_pose(pose) -> np.ndarray:
        if isinstance(pose, torch.Tensor):
            return pose.detach().cpu().numpy()
        return np.asarray(pose)

    def _cached_state(self, key, prev_np: np.ndarray, neighborhood_deg: float):
        """Host bookkeeping of one object's cached refine step: get or create
        the cache, update the prediction state, select the neighbourhood
        (prefetch ordering centres on the extrapolated next pose, constant
        angular velocity R_pred = R_rel @ R_prev; selection itself always
        uses prev, so prediction never changes results), list the misses,
        touch the LRU."""
        from freepose_tpu_torch.pipeline.fine_cache import select_neighborhood_host

        cache = self._ensure_cache(key)
        last = self._last_prev_rot.get(key)
        r_prev = prev_np[:3, :3]
        pred = (r_prev @ last.T) @ r_prev if last is not None else None
        self._last_prev_rot[key] = r_prev
        sel_idx, valid, near_extra = select_neighborhood_host(
            self._fine_rots_np, r_prev, neighborhood_deg, self.n_neighbors,
            n_extra=self.n_neighbors, extra_center=pred,
        )
        missing = cache.missing(sel_idx)
        cache.touch(sel_idx)
        return cache, sel_idx, valid, near_extra, missing

    def _ensure_cache(self, key):
        """Get or create the per-track FineViewCache for `key`."""
        from freepose_tpu_torch.pipeline.fine_cache import FineViewCache

        cache = self._fine_caches.get(key)
        if cache is None:
            cache = self._fine_caches[key] = FineViewCache(self.fine_cache_capacity)
            cfg = self.extractor.config
            res = self.renderer.resolution
            grid = res // cfg.patch_size
            cache.ensure_buffers(grid * grid, cfg.hidden_size, res, cfg.dtype, self.device)
        return cache

    def _natural_bucket(self, cache, missing) -> int:
        """Miss-bucket size for one object: the miss count plus the prefetch
        quota, rounded up a bucket."""
        from freepose_tpu_torch.pipeline.fine_cache import bucket_size

        n_dev = self.shard_mesh.shape["model"] if self.shard_mesh is not None else 1
        max_prefetch = cache.capacity - self.n_neighbors
        target = len(missing) + min(self.prefetch_quota, max_prefetch)
        return bucket_size(min(target, self.n_neighbors), self.n_neighbors, multiple=n_dev)

    def _plan_miss(self, cache, missing, near_extra, sel_idx, m_b):
        """Fill the miss batch up to the bucket with prefetch (the nearest
        uncached poses around the predicted next pose; each view is computed
        once either way), assign slots (evictions protected against the live
        neighbourhood), pad any remainder into the scratch slot."""
        max_prefetch = cache.capacity - self.n_neighbors
        pad = m_b - len(missing)
        if pad > 0:
            prefetch = cache.missing(near_extra)[: min(pad, max_prefetch)]
            missing = missing + prefetch
        pad = m_b - len(missing)
        write_slots = cache.assign_slots(missing, protect=sel_idx)
        new_idx = np.asarray(missing, np.int32)
        if pad:
            # Not enough uncached prefetch candidates: the rest of the batch
            # re-renders the first miss into the scratch slot.
            new_idx = np.concatenate([new_idx, np.full(pad, new_idx[0], np.int32)])
            write_slots = np.concatenate([write_slots, np.full(pad, cache.capacity, np.int32)])
        return new_idx, write_slots

    def refine_cached(self, proposal, proposal_mask, mesh, k, bbox, est_scale: float, prev_pose,
                      neighborhood_deg: float = 15.0, mask_scores: bool = False,
                      cache_key=None) -> PoseEstimate:
        """Refine through the fine-view cache: featurize only the query crop
        and the cache misses (pipeline/fine_cache.py)."""
        res = self.renderer.resolution
        assert proposal.shape[-1] == res, (
            f"cached refine needs the proposal crop at render resolution ({proposal.shape[-1]} vs {res})"
        )
        key = cache_key if cache_key is not None else id(mesh)
        cache, sel_idx, valid, near_extra, missing = self._cached_state(
            key, self._host_pose(prev_pose), neighborhood_deg
        )
        return self._dispatch_cached(key, cache, sel_idx, valid, near_extra, missing,
                                     proposal, proposal_mask, mesh, k, bbox, est_scale, mask_scores)

    def _dispatch_cached(self, key, cache, sel_idx, valid, near_extra, missing,
                         proposal, proposal_mask, mesh, k, bbox, est_scale, mask_scores) -> PoseEstimate:
        """One object's cached refine given its host state (from
        _cached_state): with misses the update step, all-hit the hit step."""
        from freepose_tpu_torch.pipeline.fine_cache import cached_refine_hit, cached_refine_update

        common = dict(extractor=self.extractor, layer=self.feature_layer, resolution=self.renderer.resolution,
                      mask_scores=mask_scores, rendering_scale=self.rendering_scale)
        if missing:
            m_b = self._natural_bucket(cache, missing)
            new_idx, write_slots = self._plan_miss(cache, missing, near_extra, sel_idx, m_b)
        # The neighbourhood's slots, as they stand after this step's writes.
        args = (torch.as_tensor(proposal, device=self.device), self._index(cache.gather_slots(sel_idx)),
                torch.as_tensor(valid, device=self.device), self._index(sel_idx),
                torch.as_tensor(proposal_mask, device=self.device), self._f32(k), self._f32(bbox),
                self._f32(est_scale))
        if missing:
            tcos, score, local, qf = cached_refine_update(
                cache, self.fine_poses, self._index(new_idx), self._index(write_slots),
                *self._padded_mesh(key, mesh), self.renderer.k, *args,
                settings=self.renderer.settings, pose_chunk=self.renderer.pose_chunk,
                device_mesh=self.shard_mesh, zoom=self.zoom_renders, **common,
            )
        else:
            tcos, score, local, qf = cached_refine_hit(cache, self.fine_poses, *args, **common)
        return PoseEstimate(tcos, score, args[3][local], qf)


class AutoRefineChain:
    """Pipelined refine of one track on the device-resident cache
    (fine_cache.DeviceCache). The serial refine_cached loop waits for each
    frame's pose before it selects the next frame's neighbourhood on the
    host; here the slot table, LRU ages and evictions live on the device,
    and every frame is one step that serves its own cache misses
    (fine_cache.cached_refine_auto_step). The host keeps no slot
    bookkeeping: it feeds query crops, chains each step's pose into the next
    step on the device, and reads each step's packed result `lag` frames
    behind.

    The stream step's miss bucket is small (16 by default: at a few degrees
    per frame a neighbourhood turns over a few views per frame); a frame
    with more misses flags ok=0, and the host re-dispatches it with the
    full-neighbourhood bucket (always enough) from the last good pose and
    re-enqueues the frames behind it. Results equal the serial refine_cached
    closed loop: every cached view is an exact function of its grid index,
    and eviction order changes only which later frames hit.

    Each step reads its miss count on the host to decide whether to render
    (the JAX step decides on the device with lax.cond): one wait per frame,
    on a copy enqueued before the query crop's ViT, so the card has that
    ViT queued while the host waits."""

    def __init__(self, est: OnlinePoseEstimator, mesh, cache_key=None, *, neighborhood_deg: float = 15.0,
                 mask_scores: bool = False, lag: int = 3, miss_bucket: int = 16,
                 adaptive_bucket: bool = False, bucket_choices: tuple = (8, 16, 32)):
        from freepose_tpu_torch.pipeline.fine_cache import init_device_cache

        self.est = est
        self.mesh = mesh
        self.deg = float(neighborhood_deg)
        self.mask_scores = mask_scores
        self.lag = max(1, lag)
        self.miss_bucket = miss_bucket
        # Adaptive miss bucket: the stream step's bucket follows the observed
        # miss rate. Fast motion moves to a larger bucket before overflows
        # force full re-dispatches; settled motion returns to a smaller one.
        # The bucket bounds only self-served misses and prefetch padding,
        # never the scores.
        self.adaptive = bool(adaptive_bucket)
        self.bucket_choices = tuple(sorted(set(list(bucket_choices) + [miss_bucket])))
        self._recent_miss: deque = deque(maxlen=16)
        self._last_overflow: int | None = None
        self.bucket_switches: list[tuple[int, int]] = []  # (frame, new_bucket)
        self.pending: deque = deque()
        self.results: list[tuple[np.ndarray, float]] = []
        self.n_full_redispatch = 0
        self.miss_counts: list[int] = []  # per finalized frame
        cfg = est.extractor.config
        res = est.renderer.resolution
        grid = res // cfg.patch_size
        self.state = init_device_cache(est.fine_cache_capacity, grid * grid, cfg.hidden_size, res,
                                       est.fine_poses.shape[0], cfg.dtype, est.device)
        key = cache_key if cache_key is not None else id(mesh)
        self._mesh_bufs = est._padded_mesh(key, mesh)
        self._prev_pose_dev = None
        self._prev2_pose_dev = None  # the pose the previous step used as prev

    def _step(self, inputs, prev_pose, bucket):
        from freepose_tpu_torch.pipeline.fine_cache import HostCopy, cached_refine_auto_step

        est = self.est
        # Constant-angular-velocity prefetch chains the last two prev poses on
        # the device (prev2 = prev on the first step and after a full
        # re-dispatch: no prediction for that one frame).
        prev2 = self._prev2_pose_dev
        if prev2 is None or prev_pose is not self._prev_pose_dev:
            prev2 = prev_pose
        packed, pose = cached_refine_auto_step(
            self.state, est.fine_poses, prev_pose, prev2, *self._mesh_bufs, est.renderer.k, *inputs,
            extractor=est.extractor, layer=est.feature_layer, settings=est.renderer.settings, pose_chunk=est.renderer.pose_chunk,
            resolution=est.renderer.resolution, mask_scores=self.mask_scores,
            rendering_scale=est.rendering_scale, neighborhood_deg=self.deg, n_neighbors=est.n_neighbors,
            miss_bucket=bucket, zoom=est.zoom_renders,
        )
        self._prev2_pose_dev = prev_pose
        self._prev_pose_dev = pose
        return HostCopy(packed, "refine.result")

    def submit(self, proposal, proposal_mask, k, bbox, est_scale, prev_pose=None):
        """Queue one frame. The first frame needs prev_pose (the coarse pose);
        later frames chain from the refine output (closed loop)."""
        with timing.span("refine.step"):
            est = self.est
            inputs = (torch.as_tensor(proposal, device=est.device),
                      torch.as_tensor(proposal_mask, device=est.device), est._f32(k), est._f32(bbox),
                      est._f32(est_scale))
            if self._prev_pose_dev is None:
                if prev_pose is None:
                    raise ValueError("first frame needs prev_pose")
                # Cold cache: the whole neighbourhood misses, full bucket.
                packed = self._step(inputs, est._f32(prev_pose), est.n_neighbors)
            else:
                if prev_pose is not None:
                    raise ValueError("chain is closed-loop; prev_pose only seeds frame 0")
                packed = self._step(inputs, self._prev_pose_dev, self.miss_bucket)
            timing.count("refine.frames")
            self.pending.append((inputs, packed))
            self._drain(self.lag)

    def finalize_all(self) -> list[tuple[np.ndarray, float]]:
        """Flush the pipeline -> [(pose 4x4, score)] for every frame."""
        self._drain(0)
        return self.results

    def _adapt(self, n_miss: int, overflowed: bool) -> None:
        """Move the stream bucket up or down from the observed misses."""
        if not self.adaptive:
            return
        self._recent_miss.append(n_miss)
        cur = self.miss_bucket
        if overflowed:
            # An isolated overflow is a trajectory jump, not miss pressure:
            # the full re-dispatch refills the cache. Only a second overflow
            # within 8 drained frames escalates the bucket.
            now = len(self.results)
            prev_overflow, self._last_overflow = self._last_overflow, now
            if prev_overflow is None or now - prev_overflow > 8:
                return
            bigger = [b for b in self.bucket_choices if b > cur]
            if bigger:
                # Straight to a bucket that would have absorbed this frame's
                # misses (else the largest).
                self.miss_bucket = next((b for b in bigger if b >= n_miss), bigger[-1])
                self.bucket_switches.append((len(self.results), self.miss_bucket))
                self._recent_miss.clear()
            return
        recent = list(self._recent_miss)
        # Near-capacity misses on recent frames: escalate before an overflow
        # costs a full re-dispatch and a requeue of the frames in flight.
        if len(recent) >= 4 and np.mean(recent[-4:]) > 0.75 * cur:
            bigger = [b for b in self.bucket_choices if b > cur]
            if bigger:
                self.miss_bucket = bigger[0]
                self.bucket_switches.append((len(self.results), self.miss_bucket))
                self._recent_miss.clear()
            return
        # Sustained low misses: the largest smaller bucket that still clears
        # the recent peak with headroom.
        smaller = [b for b in self.bucket_choices if b < cur]
        if len(recent) == self._recent_miss.maxlen and smaller:
            peak = max(recent)
            fit = [b for b in smaller if peak < 0.5 * b or peak == 0]
            if fit:
                self.miss_bucket = fit[-1]
                self.bucket_switches.append((len(self.results), self.miss_bucket))
                self._recent_miss.clear()

    def _drain(self, allowed: int) -> None:
        with timing.span("refine.drain"):
            while len(self.pending) > allowed:
                inputs, handle = self.pending.popleft()
                p = handle.numpy()
                if p[17] > 0.5:  # ok
                    self.results.append((p[:16].reshape(4, 4).copy(), float(p[16])))
                    self.miss_counts.append(int(p[18]))
                    self._adapt(int(p[18]), overflowed=False)
                    continue
                # Trajectory jump: re-dispatch this frame with the full bucket
                # from the last good pose, then re-enqueue the frames behind it.
                with timing.span("refine.redispatch"):
                    self.n_full_redispatch += 1
                    self._adapt(int(p[18]), overflowed=True)
                    prev = self.est._f32(self.results[-1][0])
                    packed = self._step(inputs, prev, self.est.n_neighbors)
                    rest = list(self.pending)
                    self.pending.clear()
                    self.pending.append((inputs, packed))
                    for inputs2, _ in rest:
                        self.pending.append((inputs2, self._step(inputs2, self._prev_pose_dev, self.miss_bucket)))
                if allowed > 0:
                    break
