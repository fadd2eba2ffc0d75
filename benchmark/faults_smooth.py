"""Faults planted in the program for the cells this file's faults belong to:
the smooth cell (`video.smooth.cotracker2`: CoTracker2, the
correspondences, the smoothing) and the staged cell (`video.staged.1obj`: its crops), each
where an answer or a state is produced. The benchmark's tests drive a whole
run under each and see `correct` come out false; readings_more.py reads
them on the card, to set each limit's upper end from (PERF.md). faults.py's
shape:

    with plant("cotracker2_iteration_dropped"):
        ...  # set-up, window and check of a cell

Each fault patches a class or module attribute of the program for the
duration of the block."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.faults import _patched

SHUFFLE_SEED = 7


def cotracker2_iteration_dropped():
    """CoTracker2 runs one iteration fewer in every window."""
    from freepose_tpu_torch.models.cotracker2 import CoTracker2

    forward = CoTracker2.forward

    def fewer(self, video, queries, iters=None):
        return forward(self, video, queries, (self.cfg.iters if iters is None else iters) - 1)
    return _patched(CoTracker2, "forward", fewer)


def cotracker2_overlap_dropped():
    """Each window after the first starts from the query points with fresh
    visibility, instead of carrying the previous window's predictions over
    their overlap."""
    from freepose_tpu_torch.models.cotracker2 import CoTracker2

    forward, window = CoTracker2.forward, CoTracker2.forward_window

    def new_forward(self, video, queries, iters=None):
        self.fault_queries, self.fault_windows = queries[:, 1:] / self.cfg.stride, 0
        return forward(self, video, queries, iters)

    def new_window(self, fmaps, coords, track_feat, vis, track_mask, iters):
        if self.fault_windows:
            coords = self.fault_queries[None].expand_as(coords).clone()
            vis = torch.full_like(vis, 10.0)
        self.fault_windows += 1
        return window(self, fmaps, coords, track_feat, vis, track_mask, iters)

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(CoTracker2, "forward", new_forward))
    stack.enter_context(_patched(CoTracker2, "forward_window", new_window))
    return stack


def cotracker2_corr_radius_2():
    """The correlation windows sampled at radius 2 (their outer ring of the
    radius-3 window left at nought)."""
    from freepose_tpu_torch.models import cotracker2

    sample = cotracker2.sample_windows

    def radius_2(vol, centers, radius, border=True):
        d = 2 * radius + 1
        inner = sample(vol, centers, radius - 1, border).reshape(-1, d - 2, d - 2)
        out = torch.zeros((inner.shape[0], d, d), dtype=inner.dtype, device=inner.device)
        out[:, 1:-1, 1:-1] = inner
        return out.reshape(inner.shape[0], -1)
    return _patched(cotracker2, "sample_windows", radius_2)


def cotracker2_support_dropped():
    """The predictor tracks its queries without the support grid."""
    from freepose_tpu_torch.models import cotracker2

    return _patched(cotracker2, "support_grid", lambda size, extent_hw: np.zeros((0, 2), np.float32))


def cotracker2_visibility_half():
    """The predictor's visibility threshold at 0.5 where it is 0.9."""
    from freepose_tpu_torch.models import cotracker2

    return _patched(cotracker2, "VISIBILITY_THRESHOLD", 0.5)


def surface_shuffled():
    """Each interval's surface points shuffled against its query points."""
    from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner

    corr = TrackingRefiner.compute_2d3d_correspondences

    def shuffled(self, *args, **kwargs):
        query, surface, valid = corr(self, *args, **kwargs)
        perm = torch.randperm(surface.shape[0], generator=torch.Generator().manual_seed(SHUFFLE_SEED))
        return query, surface[perm.to(surface.device) if torch.is_tensor(surface) else perm.numpy()], valid
    return _patched(TrackingRefiner, "compute_2d3d_correspondences", shuffled)


def smoothing_skipped():
    """smooth_track hands back its EPnP track unsmoothed."""
    from freepose_tpu_torch.scripts import smooth_poses_video

    return _patched(smooth_poses_video, "smooth_transforms", lambda tcos: torch.as_tensor(tcos, dtype=torch.float32))


def staged_crops_shifted():
    """extract_proposals' crops one pixel off to the right (the staged
    cell's crops)."""
    from freepose_tpu_torch.pipeline import proposals

    extract = proposals.extract_proposals

    def shifted(*args, **kwargs):
        out = extract(*args, **kwargs)
        out.proposals = torch.roll(out.proposals, 1, dims=-1)
        return out
    return _patched(proposals, "extract_proposals", shifted)


FAULTS = {f.__name__: f for f in (cotracker2_iteration_dropped, cotracker2_overlap_dropped, cotracker2_corr_radius_2,
                                   cotracker2_support_dropped, cotracker2_visibility_half, surface_shuffled,
                                   smoothing_skipped, staged_crops_shifted)}


@contextlib.contextmanager
def plant(*names: str):
    """The named faults, all at once, for the duration of the block."""
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(FAULTS[name]())
        yield
