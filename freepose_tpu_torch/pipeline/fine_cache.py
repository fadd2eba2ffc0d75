"""Fine-grid view cache: render, feature and stats reuse across video frames.

Counterpart of freepose_tpu.pipeline.fine_cache. Every per-view quantity the
rescore consumes (normalized patch features, render mask, pointcloud stats)
is a pure function of (mesh, fine-grid pose index), and consecutive frames'
neighbourhoods overlap almost entirely. So caching per-view results by grid
index makes a refine step featurize only the query crop and the few views
entering the neighbourhood: an exact reuse, not an approximation.

Two forms, as in the JAX package:
  * `FineViewCache`: device buffers with the LRU slot bookkeeping on the host
    (the serial `OnlinePoseEstimator.refine_cached`), neighbourhoods chosen
    on the host (`select_neighborhood_host`);
  * `DeviceCache` + `cached_refine_auto_step`: slot table, LRU ages and
    evictions on the device, each step serving its own misses
    (`AutoRefineChain`).

The JAX functions return new (donated) buffers; here the cache tensors are
updated in place. Padded writes all land in the scratch slot `capacity`,
where duplicate writes leave any one of them: the scratch slot is never read
with a valid mask.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from freepose_tpu_torch.geometry.rotation import TRACE_TERMS, geodesic_distance
from freepose_tpu_torch.pipeline.online_pose_estimator import (
    render_view_block,
    rescore_views,
    score_and_lift_from_stats,
    select_neighborhood,
    shard_views,
)
from freepose_tpu_torch.pipeline.template_bank import normalize_feats
from freepose_tpu_torch.utils import timing

_INT32_MAX = torch.iinfo(torch.int32).max


def _grid_dists_deg(fine_rots: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """geometry.rotation.geodesic_distance in numpy, the same float64
    arithmetic in the same order, so host and device order a grid alike."""
    r = np.asarray(fine_rots, np.float32).astype(np.float64)
    q = np.asarray(rot, np.float32).astype(np.float64)
    tr = r[:, 0, 0] * q[0, 0]
    for i, j in TRACE_TERMS[1:]:
        tr = tr + r[:, i, j] * q[i, j]
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def select_neighborhood_host(
    fine_rots: np.ndarray,  # [N, 3, 3] pose-grid rotations
    prev_rot: np.ndarray,  # [3, 3]
    neighborhood_deg: float,
    n_neighbors: int,
    n_extra: int = 0,
    extra_center: np.ndarray | None = None,  # [3, 3] prefetch-ordering centre
):
    """Host mirror of online_pose_estimator.select_neighborhood: the nearest
    n_neighbors grid indices (ascending distance, equal distances lowest
    index first) + the within-threshold mask (index 0 always kept). With
    n_extra > 0 also n_extra prefetch candidates outside the neighbourhood,
    nearest to `extra_center` (default: prev_rot). Prefetch ordering never
    affects the selection."""
    dists = _grid_dists_deg(fine_rots, prev_rot)
    if not n_extra:
        idx = np.argsort(dists, kind="stable")[:n_neighbors]
        mask = dists[idx] < neighborhood_deg
        mask[0] = True
        return idx.astype(np.int32), mask
    order = np.argsort(dists, kind="stable")[: n_neighbors + n_extra]
    idx = order[:n_neighbors]
    mask = dists[idx] < neighborhood_deg
    mask[0] = True
    if extra_center is None:
        extra = order[n_neighbors:]
    else:
        pd = _grid_dists_deg(fine_rots, extra_center)
        pd[idx] = np.inf  # never re-offer the selected neighbourhood
        extra = np.argsort(pd, kind="stable")[:n_extra]
    return idx.astype(np.int32), mask, extra.astype(np.int32)


class FineViewCache:
    """Per-track cache of fine-grid view data on the device.

    Buffers hold `capacity`+1 slots; the extra slot (index `capacity`) is the
    scratch target of a bucket's padded writes and is never read. Slot
    assignment and the LRU live on the host; the data stays on the device."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.slot_of: dict[int, int] = {}
        self.lru: OrderedDict[int, None] = OrderedDict()
        self.free: list[int] = list(range(capacity))
        self.feats = None  # [C+1, G², D]
        self.masks = None  # [C+1, R, R] bool
        self.stats = None  # [C+1, 3, 3] (min, max, mean rows)

    def ensure_buffers(self, g2: int, d: int, res: int, dtype, device=None) -> None:
        if self.feats is None:
            c = self.capacity + 1
            self.feats = torch.zeros((c, g2, d), dtype=dtype, device=device)
            self.masks = torch.zeros((c, res, res), dtype=torch.bool, device=device)
            self.stats = torch.zeros((c, 3, 3), dtype=torch.float32, device=device)

    def touch(self, indices) -> None:
        for i in indices:
            i = int(i)
            if i in self.lru:
                self.lru.move_to_end(i)

    def missing(self, indices: np.ndarray) -> list[int]:
        """Grid indices of `indices` not yet cached, in selection order."""
        return [int(i) for i in indices if int(i) not in self.slot_of]

    def drop(self, indices) -> None:
        """Invalidate entries (testing / forced-miss warmup)."""
        for gi in indices:
            gi = int(gi)
            if gi in self.slot_of:
                self.free.append(self.slot_of.pop(gi))
                del self.lru[gi]

    def assign_slots(self, missing: list[int], protect: np.ndarray) -> np.ndarray:
        """A slot per missing grid index, evicting the least recently used
        entries not in `protect` (the current neighbourhood) when full.
        Entries assigned within this call are protected from its later
        evictions; with capacity ≥ n_neighbors every real miss finds a
        victim (the caller caps prefetch)."""
        protected = set(int(i) for i in protect)
        slots = []
        for gi in missing:
            if self.free:
                slot = self.free.pop()
            else:
                victim = next(i for i in self.lru if i not in protected)
                slot = self.slot_of.pop(victim)
                del self.lru[victim]
            self.slot_of[gi] = slot
            self.lru[gi] = None
            protected.add(gi)
            slots.append(slot)
        return np.asarray(slots, np.int32)

    def gather_slots(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray([self.slot_of[int(i)] for i in indices], np.int32)


def bucket_size(m: int, n_neighbors: int, buckets=(4, 8, 16), multiple: int = 1) -> int:
    """Miss-batch sizes come from a few buckets (each one compiled program
    in the JAX package, here a few batch shapes). `multiple` keeps buckets
    that divide a device count."""
    for b in buckets:
        if m <= b < n_neighbors and b % multiple == 0:
            return b
    return n_neighbors


class HostCopy:
    """A device tensor's value copied to the host behind the work enqueued
    so far: reading it waits for that copy only, not for work enqueued
    after it (the JAX package's copy_to_host_async). On the CPU the tensor
    itself. Each read is the span `wait.<name>` (utils/timing.py)."""

    def __init__(self, x: torch.Tensor, name: str):
        self._name = name
        self._event = None
        if x.device.type == "cuda":
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = x

    def numpy(self) -> np.ndarray:
        with timing.wait(self._name):
            if self._event is not None:
                self._event.synchronize()
            return self._host.numpy()


def _features(extractor, images, layer):
    return normalize_feats(extractor(images, layer=layer, feature_type="patch"))


def _gather_rescore_lift(feats_buf, masks_buf, stats_buf, qf, gather_slots, valid, sel_poses,
                         proposal_mask, k, bbox, est_scale, *, resolution, patch_size, mask_scores,
                         rendering_scale):
    grid = resolution // patch_size
    rf = feats_buf[gather_slots].to(qf.dtype)
    st = stats_buf[gather_slots]
    scores = rescore_views(rf, qf, valid, masks_buf[gather_slots], proposal_mask, grid, mask_scores)
    return score_and_lift_from_stats(scores, st[:, 0], st[:, 1], st[:, 2], sel_poses, k, bbox, est_scale,
                                     rendering_scale)


def cached_refine_update(
    cache: FineViewCache,
    fine_poses,  # [NF, 4, 4] the fine grid (on the device)
    new_idx,  # [M] fine-grid indices of the misses (and prefetch, padding)
    write_slots,  # [M] target slots (the scratch slot for padding)
    v, c, f, fv, k_render,  # padded mesh + render intrinsics
    proposal,  # [3, R, R] query crop
    gather_slots,  # [N] neighbourhood slots (valid after the writes)
    valid,  # [N] bool within-threshold mask
    sel_idx,  # [N] neighbourhood fine-grid indices
    proposal_mask,  # [R, R] bool
    k,  # [3, 3] query intrinsics
    bbox,  # [4] xyxy
    est_scale,
    *, extractor, layer, settings, pose_chunk, resolution, mask_scores, rendering_scale, device_mesh=None,
    shard_axis="model", zoom=False,
):
    """Miss step: render the M views, featurize them in one batch with the
    query crop, write them into the cache, gather the neighbourhood,
    rescore, z-lift -> (tcos, score, local index, query features).

    With `device_mesh` the M views' renders and features split over
    `shard_axis` (M must divide over it: bucket_size(multiple=)) and are
    gathered on mesh.first, where the cache lives and the query crop is
    featurized alone; the writes, gather and epilogue are unchanged (the
    JAX package replicates the cache and runs them on every device)."""
    if device_mesh is None:
        props, rmasks, (smin, smax, smean) = render_view_block(
            v, c, f, fv, fine_poses[new_idx], k_render, settings, pose_chunk, resolution, zoom,
        )
        feats = _features(extractor, torch.cat([proposal[None].to(props.dtype), props]), layer)
        qf, new_feats = feats[0], feats[1:]
    else:
        new_feats, rmasks, (smin, smax, smean) = shard_views(
            fine_poses[new_idx], v, c, f, fv, k_render, settings, pose_chunk, resolution, extractor, layer,
            device_mesh, shard_axis, zoom,
        )
        qf = _features(extractor, proposal[None], layer)[0]
    cache.feats[write_slots] = new_feats.to(cache.feats.dtype)
    cache.masks[write_slots] = rmasks
    cache.stats[write_slots] = torch.stack([smin, smax, smean], dim=1)
    tcos, score, local = _gather_rescore_lift(
        cache.feats, cache.masks, cache.stats, qf, gather_slots, valid, fine_poses[sel_idx],
        proposal_mask, k, bbox, est_scale, resolution=resolution, patch_size=extractor.config.patch_size,
        mask_scores=mask_scores, rendering_scale=rendering_scale,
    )
    return tcos, score, local, qf


def cached_refine_hit(
    cache: FineViewCache, fine_poses, proposal, gather_slots, valid, sel_idx, proposal_mask, k, bbox, est_scale,
    *, extractor, layer, resolution, mask_scores, rendering_scale,
):
    """All-hit step: featurize only the query crop, gather the cached
    neighbourhood, rescore, z-lift."""
    qf = _features(extractor, proposal[None], layer)[0]
    tcos, score, local = _gather_rescore_lift(
        cache.feats, cache.masks, cache.stats, qf, gather_slots, valid, fine_poses[sel_idx],
        proposal_mask, k, bbox, est_scale, resolution=resolution, patch_size=extractor.config.patch_size,
        mask_scores=mask_scores, rendering_scale=rendering_scale,
    )
    return tcos, score, local, qf


def cached_refine_update_multi(
    caches,  # M FineViewCaches
    fine_poses,
    new_idx,  # [M, B] miss fine-grid indices (bucket B shared: max of the natural ones)
    write_slots,  # [M, B]
    meshes,  # M padded-mesh 4-tuples (v, c, f, fv)
    k_render,
    proposals,  # [M, 3, R, R]
    gather_slots,  # [M, N]
    valid,  # [M, N]
    sel_idx,  # [M, N]
    proposal_masks,  # [M, R, R]
    ks, bboxes, est_scales,  # [M, 3, 3], [M, 4], [M]
    *, extractor, layer, settings, pose_chunk, resolution, mask_scores, rendering_scale, zoom=False,
):
    """Multi-object miss step for a frame: render each object's views,
    featurize every query crop and render as one ViT batch, write each
    object's cache, gather/rescore/lift per object. Objects with fewer
    misses get extra prefetch, which never changes results."""
    m = len(caches)
    b = new_idx.shape[1]
    props_list, rmasks_list, stats_list = [], [], []
    for i in range(m):
        v, c, f, fv = meshes[i]
        props, rmasks, (smin, smax, smean) = render_view_block(
            v, c, f, fv, fine_poses[new_idx[i]], k_render, settings, pose_chunk, resolution, zoom,
        )
        props_list.append(props)
        rmasks_list.append(rmasks)
        stats_list.append(torch.stack([smin, smax, smean], dim=1))
    feats = _features(extractor, torch.cat([proposals.to(props_list[0].dtype)] + props_list), layer)
    qf = feats[:m]
    tcos, scores, locals_ = [], [], []
    for i, cache in enumerate(caches):
        cache.feats[write_slots[i]] = feats[m + i * b : m + (i + 1) * b].to(cache.feats.dtype)
        cache.masks[write_slots[i]] = rmasks_list[i]
        cache.stats[write_slots[i]] = stats_list[i]
        t, s, loc = _gather_rescore_lift(
            cache.feats, cache.masks, cache.stats, qf[i], gather_slots[i], valid[i], fine_poses[sel_idx[i]],
            proposal_masks[i], ks[i], bboxes[i], est_scales[i], resolution=resolution,
            patch_size=extractor.config.patch_size, mask_scores=mask_scores, rendering_scale=rendering_scale,
        )
        tcos.append(t)
        scores.append(s)
        locals_.append(loc)
    return torch.stack(tcos), torch.stack(scores), torch.stack(locals_), qf


def cached_refine_hit_multi(
    caches, fine_poses, proposals, gather_slots, valid, sel_idx, proposal_masks, ks, bboxes, est_scales,
    *, extractor, layer, resolution, mask_scores, rendering_scale,
):
    """Multi-object all-hit step: the M query crops featurize as one ViT
    batch, then each object gathers from its own cache and rescores."""
    qf = _features(extractor, proposals, layer)  # [M, G², D]
    tcos, scores, locals_ = [], [], []
    for i, cache in enumerate(caches):
        t, s, loc = _gather_rescore_lift(
            cache.feats, cache.masks, cache.stats, qf[i], gather_slots[i], valid[i], fine_poses[sel_idx[i]],
            proposal_masks[i], ks[i], bboxes[i], est_scales[i], resolution=resolution,
            patch_size=extractor.config.patch_size, mask_scores=mask_scores, rendering_scale=rendering_scale,
        )
        tcos.append(t)
        scores.append(s)
        locals_.append(loc)
    return torch.stack(tcos), torch.stack(scores), torch.stack(locals_), qf


# --------------------------------------------------------------------------- #
# Device-side cache: slot table, LRU ages and evictions live in device
# tensors, and each step serves its own misses. The host keeps no slot
# bookkeeping.
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class DeviceCache:
    feats: torch.Tensor  # [C+1, G², D] (+1 scratch slot)
    masks: torch.Tensor  # [C+1, R, R] bool
    stats: torch.Tensor  # [C+1, 3, 3]
    slot_table: torch.Tensor  # [NF+1] int32, -1 = uncached (+1 scratch row)
    grid_of: torch.Tensor  # [C+1] int64 resident grid index (NF = none)
    last_used: torch.Tensor  # [C+1] int32 frame of last touch (-1 = free)
    frame: torch.Tensor  # [] int32 step counter


def init_device_cache(capacity: int, g2: int, d: int, res: int, n_fine: int, dtype, device=None) -> DeviceCache:
    c = capacity + 1
    return DeviceCache(
        feats=torch.zeros((c, g2, d), dtype=dtype, device=device),
        masks=torch.zeros((c, res, res), dtype=torch.bool, device=device),
        stats=torch.zeros((c, 3, 3), dtype=torch.float32, device=device),
        slot_table=torch.full((n_fine + 1,), -1, dtype=torch.int32, device=device),
        grid_of=torch.full((c,), n_fine, dtype=torch.long, device=device),
        last_used=torch.full((c,), -1, dtype=torch.int32, device=device),
        frame=torch.zeros((), dtype=torch.int32, device=device),
    )


def lru_victims(last_used: torch.Tensor, protect: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Slots for a miss batch: entry i (where `real`) takes the next least
    recently used unprotected slot, free slots (age -1) first and the lowest
    slot among equal ages; every other entry, and a real one once no
    unprotected slot is left, takes the scratch slot (the last). The JAX
    step picks them one by one in a loop of argmins, protecting each pick;
    since each real entry takes the next slot of one stable sort, one sort
    gives the same slots (tests/test_torch_fine_cache.py holds it to that
    loop)."""
    capacity = last_used.shape[0] - 1
    cand = torch.where(protect, _INT32_MAX, last_used)
    order = torch.argsort(cand, stable=True)
    rank = torch.clamp(torch.cumsum(real.to(torch.long), 0) - 1, 0, capacity)  # past the last: exhausted
    pick = order[rank]
    return torch.where(real & (cand[pick] != _INT32_MAX), pick, capacity)


def geodesic_all(fine_poses: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return geodesic_distance(fine_poses[:, :3, :3], pose[:3, :3])


def _serve_misses(state: DeviceCache, m: int, idx, slots0, miss_mask, fine_poses, prev_pose, prev2_pose,
                  v, c, f, fv, k_render, *, extractor, layer, settings, pose_chunk, resolution, n_neighbors,
                  miss_bucket, zoom):
    """The miss branch of cached_refine_auto_step: render and featurize
    `miss_bucket` views (the step's first misses in selection order, then
    prefetch, then padding), evict LRU slots for them and map them."""
    dev = idx.device
    n_fine = fine_poses.shape[0]
    capacity = state.feats.shape[0] - 1
    n = idx.shape[0]
    order = torch.argsort(torch.where(miss_mask, 0, 1) * n + torch.arange(n, device=dev))
    miss_sorted = idx[order]
    # Prefetch ordering centres on the constant-angular-velocity
    # extrapolation of the track, R_pred = R_rel @ R_prev (the host planner's
    # formula, OnlinePoseEstimator._cached_state); selection above used the
    # true prev, so prediction only shifts which later frames hit.
    r_prev = prev_pose[:3, :3]
    pred_pose = prev_pose.clone()
    pred_pose[:3, :3] = (r_prev @ prev2_pose[:3, :3].T) @ r_prev
    pd = torch.where(state.slot_table[:n_fine] >= 0, torch.inf, geodesic_all(fine_poses, pred_pose))
    with timing.wait("refine.prefetch"):  # writing a host scalar synchronises
        pd[idx] = torch.inf
    pf_idx = torch.argsort(pd, stable=True)[:miss_bucket]
    pf_real = torch.isfinite(pd[pf_idx])

    pos = torch.arange(miss_bucket, device=dev)
    take_miss = pos < m
    pfi = torch.clamp(pos - m, 0, miss_bucket - 1)
    gi = torch.where(take_miss, miss_sorted[torch.clamp(pos, max=n - 1)], pf_idx[pfi])
    # Prefetch writes are capped at capacity - n_neighbors: every extra write
    # shrinks the evictable pool (the host planner's max_prefetch).
    max_prefetch = max(0, capacity - n_neighbors)
    real = take_miss | (pf_real[pfi] & (pos < m + max_prefetch))
    # Overflow (m > miss_bucket): only the first miss_bucket misses are served.
    gi = torch.where(real, gi, miss_sorted[0])

    # Protected: the neighbourhood's residents, the scratch slot, and each
    # slot as it is picked.
    protect = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
    with timing.wait("refine.protect"):  # writing host scalars synchronises
        protect[torch.where(slots0 >= 0, slots0.long(), capacity)] = True
        protect[capacity] = True
    victims = lru_victims(state.last_used, protect, real)

    props, rmasks, (smin, smax, smean) = render_view_block(
        v, c, f, fv, fine_poses[gi], k_render, settings, pose_chunk, resolution, zoom,
    )
    state.feats[victims] = _features(extractor, props, layer).to(state.feats.dtype)
    state.masks[victims] = rmasks
    state.stats[victims] = torch.stack([smin, smax, smean], dim=1)

    # Table: unmap the victims' old residents, then map the new ones (old
    # residents were cached, new ones were not: disjoint). Entries that went
    # to the scratch slot map nothing, so no grid index points at scratch.
    wrote = victims < capacity
    gi_write = torch.where(wrote, gi, n_fine)
    with timing.wait("refine.slot_table"):  # writing host scalars synchronises
        state.slot_table[state.grid_of[victims]] = -1
        state.slot_table[gi_write] = victims.to(torch.int32)
        state.slot_table[n_fine] = -1
    state.grid_of[victims] = gi_write
    state.last_used[victims] = torch.where(wrote, state.frame, state.last_used[victims])


def cached_refine_auto_step(
    state: DeviceCache,
    fine_poses,  # [NF, 4, 4]
    prev_pose,  # [4, 4] previous frame's refined pose (chained on the device)
    prev2_pose,  # [4, 4] the pose the previous step used as prev (prefetch
    #              extrapolation; pass prev_pose again to turn prediction off)
    v, c, f, fv, k_render,  # padded mesh + render intrinsics
    proposal, proposal_mask, k, bbox, est_scale,
    *, extractor, layer, settings, pose_chunk, resolution, mask_scores, rendering_scale, neighborhood_deg,
    n_neighbors, miss_bucket, zoom=False,
):
    """One refine step on the device cache: select the neighbourhood, serve
    up to `miss_bucket` misses (render + featurize + LRU-evict + write),
    rescore, z-lift; `state` is updated in place. Returns (packed, tcos)
    where packed = [16 tcos | score | ok | n_miss] f32, for the host to read
    later, and tcos [4, 4] chains into the next step's prev_pose. ok = 0
    (more than miss_bucket misses, a trajectory jump) tells the host to run
    the frame again with miss_bucket = n_neighbors, which always succeeds.

    The host reads the miss count to decide whether to render (lax.cond in
    the JAX step): its copy is enqueued before the query crop's ViT and
    read after the ViT is enqueued, so the card has work queued while the
    host waits."""
    capacity = state.feats.shape[0] - 1
    sel_poses, idx, valid = select_neighborhood(fine_poses, prev_pose, neighborhood_deg, n_neighbors)
    slots0 = state.slot_table[idx]
    miss_mask = slots0 < 0
    m_dev = miss_mask.sum()
    m_host = HostCopy(m_dev, "refine.miss_count")
    with timing.span("refine.query_features"):
        qf = _features(extractor, proposal[None], layer)[0]
    m = int(m_host.numpy())
    if m > 0:
        with timing.span("refine.miss"):
            _serve_misses(state, m, idx, slots0, miss_mask, fine_poses, prev_pose, prev2_pose, v, c, f, fv,
                          k_render, extractor=extractor, layer=layer, settings=settings, pose_chunk=pose_chunk,
                          resolution=resolution, n_neighbors=n_neighbors, miss_bucket=miss_bucket, zoom=zoom)

    with timing.span("refine.rescore"):
        slots_after = state.slot_table[idx].long()
        present = slots_after >= 0
        gather = torch.where(present, slots_after, capacity)
        tcos, score, local = _gather_rescore_lift(
            state.feats, state.masks, state.stats, qf, gather, valid & present, sel_poses, proposal_mask, k, bbox,
            est_scale, resolution=resolution, patch_size=extractor.config.patch_size, mask_scores=mask_scores,
            rendering_scale=rendering_scale,
        )
        # Touch the neighbourhood (LRU recency) and advance the clock.
        state.last_used[gather] = torch.where(present, state.frame, state.last_used[gather])
        with timing.wait("refine.lru"):  # writing a host scalar synchronises
            state.last_used[capacity] = -1
    state.frame += 1
    ok = m_dev <= miss_bucket
    packed = torch.cat([tcos[0].reshape(-1).float(),
                        torch.stack([score[0].float(), ok.float(), m_dev.float()])])
    return packed, tcos[0]
