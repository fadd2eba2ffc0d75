"""Faults planted in the program, each where an answer or a state is
produced. The benchmark's tests drive a whole run under each and see
`correct` come out false; readings.py reads them on the card at a cell's
own size, to set each limit's upper end from (PERF.md).

    with plant("refine_stale", "crops_shifted"):
        ...  # set-up, window and check of a cell

Each fault patches a class or module attribute of the program for the
duration of the block."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

TURN = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)  # 90 degrees about z
LIFT_FACTOR = 1.05  # refine_lift_off: every refined translation 5% too far


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _chain_results(alter):
    """Patches AutoRefineChain so that each result it finalizes passes
    through alter(chain, i, pose, score) -> (pose, score); the chain's own
    walk on the device goes on from its true poses."""
    from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain

    drain, submit = AutoRefineChain._drain, AutoRefineChain.submit

    def new_submit(self, *args, prev_pose=None, **kwargs):
        if prev_pose is not None:
            self.fault_seed_pose = np.asarray(prev_pose, np.float32)
        return submit(self, *args, prev_pose=prev_pose, **kwargs)

    def new_drain(self, allowed):
        n = len(self.results)
        drain(self, allowed)
        for i in range(n, len(self.results)):
            pose, score = self.results[i]
            self.results[i] = alter(self, i, pose.copy(), score)

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(AutoRefineChain, "submit", new_submit))
    stack.enter_context(_patched(AutoRefineChain, "_drain", new_drain))
    return stack


def _previous(chain, i: int) -> np.ndarray:
    return chain.results[i - 1][0] if i > 0 else chain.fault_seed_pose


def sam2_masks_flipped():
    """Every high-res mask of propagate_batched inverted."""
    from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor

    batched = Sam2VideoPredictor.propagate_batched

    def flipped(self, *args, **kwargs):
        for ts, lows, highs, frames in batched(self, *args, **kwargs):
            yield ts, lows, ~highs, frames
    return _patched(Sam2VideoPredictor, "propagate_batched", flipped)


def sam2_memory_frozen():
    """A SAM2 step that returns its memory state unchanged."""
    from freepose_tpu_torch.models.sam2.video import Sam2VideoModel

    step = Sam2VideoModel.track_step
    fields = ("maskmem", "maskmem_frame", "maskmem_valid", "ptrs", "ptr_frame", "ptr_valid", "ring_pos",
              "ptr_ring_pos")

    def frozen(self, state, *args, is_init=False, **kwargs):
        if is_init:
            return step(self, state, *args, is_init=is_init, **kwargs)
        kept = [getattr(state, f) for f in fields]
        kept = [x.clone() if torch.is_tensor(x) else x for x in kept]
        state, out = step(self, state, *args, is_init=is_init, **kwargs)
        for f, x in zip(fields, kept):
            setattr(state, f, x)
        return state, out
    return _patched(Sam2VideoModel, "track_step", frozen)


def sam2_wrong_candidate():
    """SAM2 takes the candidate mask of the lowest predicted IoU where it
    should take the highest."""
    from freepose_tpu_torch.models.sam2.model import Sam2ImageModel

    decode = Sam2ImageModel.decode_masks

    def wrong(self, *args, multimask_output=True, **kwargs):
        masks, iou, tokens, obj = decode(self, *args, multimask_output=multimask_output, **kwargs)
        return masks, (-iou if multimask_output else iou), tokens, obj
    return _patched(Sam2ImageModel, "decode_masks", wrong)


def crops_shifted():
    """proposals_from_masks_video's crops one pixel off to the right."""
    from freepose_tpu_torch.pipeline import proposals

    crop = proposals.proposals_from_masks_video

    def shifted(*args, **kwargs):
        crops, masks, boxes = crop(*args, **kwargs)
        return torch.roll(crops, 1, dims=-1), masks, boxes
    return _patched(proposals, "proposals_from_masks_video", shifted)


def coarse_turned():
    """Frame 0's coarse pose turned 90 degrees."""
    from freepose_tpu_torch.pipeline.pose_estimator import CoarsePoseEstimator

    estimate = CoarsePoseEstimator.estimate

    def turned(self, *args, **kwargs):
        out = estimate(self, *args, **kwargs)
        out.tcos[:, :3, :3] = torch.as_tensor(TURN, device=out.tcos.device) @ out.tcos[:, :3, :3]
        return out
    return _patched(CoarsePoseEstimator, "estimate", turned)


def refine_turned():
    """Every refined pose turned 90 degrees."""
    def alter(chain, i, pose, score):
        pose[:3, :3] = TURN @ pose[:3, :3]
        return pose, score
    return _chain_results(alter)


def refine_stale():
    """A refine step that returns its state unchanged: each frame's pose is
    the one it was handed (frame 0's coarse pose, all through)."""
    def alter(chain, i, pose, score):
        return _previous(chain, i).copy(), score
    return _chain_results(alter)


def refine_wrong_view():
    """Each refined pose takes the rotation of another view of its
    neighbourhood: one drawn from the valid views of the previous pose's
    neighbourhood, other than the chosen one."""
    from freepose_tpu_torch.pipeline.online_pose_estimator import select_neighborhood

    def alter(chain, i, pose, score):
        est = chain.est
        prev = torch.as_tensor(_previous(chain, i), dtype=torch.float32, device=est.fine_poses.device)
        cand, _, valid = select_neighborhood(est.fine_poses, prev, chain.deg, est.n_neighbors)
        rots = cand[valid][:, :3, :3].cpu().numpy()
        cos = (np.einsum("nij,ij->n", rots, pose[:3, :3]) - 1.0) / 2.0
        others = np.flatnonzero(cos < np.max(cos) - 1e-6)
        if others.size:
            pose[:3, :3] = rots[np.random.default_rng(i).choice(others)]
        return pose, score
    return _chain_results(alter)


def refine_lift_off():
    """Every refined translation 5% too far along its ray."""
    def alter(chain, i, pose, score):
        pose[:3, 3] *= LIFT_FACTOR
        return pose, score
    return _chain_results(alter)


def inliers_unmasked():
    """StreamingInliers' cosines kept off the render's mask as well."""
    from freepose_tpu_torch.pipeline import tracking_refiner

    mask37 = tracking_refiner._mask37

    def unmasked(depth):
        return torch.ones_like(mask37(depth))
    return _patched(tracking_refiner, "_mask37", unmasked)


FAULTS = {f.__name__: f for f in (sam2_masks_flipped, sam2_memory_frozen, sam2_wrong_candidate, crops_shifted,
                                   coarse_turned, refine_turned, refine_stale, refine_wrong_view, refine_lift_off,
                                   inliers_unmasked)}


@contextlib.contextmanager
def plant(*names: str):
    """The named faults, all at once, for the duration of the block."""
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(FAULTS[name]())
        yield
