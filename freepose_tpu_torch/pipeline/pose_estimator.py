"""Coarse 6D pose estimation by template matching.

Counterpart of freepose_tpu.pipeline.pose_estimator: cosine-score the query
proposal's DINOv2 patch features against a mesh's 600 template views, keep
the top 3, and lift each winning template pose to metric depth from the
detection bbox, all on the compact TemplatePack.
"""
from __future__ import annotations

import dataclasses

import torch

from freepose_tpu_torch.geometry.rotation import template_poses as make_template_poses
from freepose_tpu_torch.pipeline.renderer import RENDERING_SCALE
from freepose_tpu_torch.pipeline.template_bank import TemplateBank, TemplatePack, normalize_feats
from freepose_tpu_torch.utils import timing


@dataclasses.dataclass
class PoseEstimate:
    tcos: torch.Tensor  # [k, 4, 4] lifted poses, best first
    scores: torch.Tensor  # [k]
    view_indices: torch.Tensor  # [k]
    query_feat: torch.Tensor | None = None  # [G², D] normalized
    all_scores: torch.Tensor | None = None  # [V] per-view scores (opt-in)


def score_and_lift(
    feats_template: torch.Tensor,  # [V, G², D] normalized
    query_feat: torch.Tensor,  # [G², D] normalized
    pc_min: torch.Tensor,  # [V, 3]
    pc_max: torch.Tensor,  # [V, 3]
    pc_mean: torch.Tensor,  # [V, 3]
    poses: torch.Tensor,  # [V, 4, 4]
    k: torch.Tensor,  # [3, 3] query-camera intrinsics
    bbox: torch.Tensor,  # [4] xyxy detection bbox
    est_scale: torch.Tensor,  # scalar metric half-extent estimate
    top_k: int = 3,
    rendering_scale: float = RENDERING_SCALE,
    return_all_scores: bool = False,
):
    """Mean patch-cosine score over views + bbox z-lift of the top-k poses.

    The scoring product runs in fp32 whatever the features' dtype (the JAX
    version asks for an fp32 result of its bf16 einsum). Top-k takes a
    stable descending sort, so equal scores keep the lower view index first,
    as lax.top_k does (torch.topk promises no order among ties)."""
    scores = torch.einsum("vgd,gd->vg", feats_template.float(), query_feat.float()).mean(dim=-1)
    order = torch.sort(scores, descending=True, stable=True).indices[:top_k]
    top_scores, top_idx = scores[order], order

    # z-lift from template pointcloud extents, rescaled from render scale to
    # the metric estimate: extent' = (extent - mean) * est_scale/render + mean.
    s = est_scale / rendering_scale
    mean = pc_mean[top_idx]
    mins = (pc_min[top_idx] - mean) * s + mean  # [k, 3]
    maxs = (pc_max[top_idx] - mean) * s + mean

    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    bb_dx = (bbox[2] - bbox[0]) + 1.0
    bb_dy = (bbox[3] - bbox[1]) + 1.0
    z = (fx * (maxs[:, 0] - mins[:, 0]) / bb_dx + fy * (maxs[:, 1] - mins[:, 1]) / bb_dy) / 2.0
    bb_cx = (bbox[0] + bbox[2]) / 2.0
    bb_cy = (bbox[1] + bbox[3]) / 2.0
    x = (bb_cx - cx) * z / fx
    y = (bb_cy - cy) * z / fy

    tcos = poses[top_idx].clone()
    tcos[:, 0, 3] = x
    tcos[:, 1, 3] = y
    tcos[:, 2, 3] = z
    if return_all_scores:
        return tcos, top_scores, top_idx, scores
    return tcos, top_scores, top_idx


class CoarsePoseEstimator:
    """Template-matching coarse pose, one mesh at a time.

    feature_fn(images [B,3,T,T]) -> [B, G², D] layer-truncated DINOv2 patch
    tokens (the extractor owns layer selection).
    """

    def __init__(self, feature_fn, bank: TemplateBank, n_poses: int = 600):
        self.feature_fn = feature_fn
        self.bank = bank
        self.mesh_poses = make_template_poses(n_poses, device=bank.device)

    def _f32(self, x) -> torch.Tensor:
        with timing.wait("coarse.inputs"):  # an upload from pageable memory synchronises
            return torch.as_tensor(x, dtype=torch.float32, device=self.bank.device)

    def query_features(self, proposal: torch.Tensor) -> torch.Tensor:
        """[3, T, T] proposal crop -> [G², D] normalized patch features."""
        return normalize_feats(self.feature_fn(proposal[None])[0])

    def estimate(
        self,
        proposal: torch.Tensor,
        pack: TemplatePack,
        k: torch.Tensor,
        bbox,
        est_scale: float,
        top_k: int = 3,
        return_query_feat: bool = False,
        return_all_scores: bool = False,
    ) -> PoseEstimate:
        qf = self.query_features(proposal)
        out = score_and_lift(
            pack.feats, qf, pack.pc_min, pack.pc_max, pack.pc_mean, pack.poses,
            self._f32(k), self._f32(bbox), self._f32(est_scale), top_k,
            return_all_scores=return_all_scores,
        )
        tcos, scores, idx = out[:3]
        return PoseEstimate(tcos, scores, idx, qf if return_query_feat else None,
                            out[3] if return_all_scores else None)

    def estimate_batch(
        self,
        proposals: torch.Tensor,  # [P, 3, T, T] all proposals of a frame
        packs: list,  # P TemplatePacks (typically distinct meshes)
        k: torch.Tensor,
        boxes,  # [P, 4] xyxy
        est_scales,  # [P]
        top_k: int = 3,
    ) -> list[PoseEstimate]:
        """Frame-level batching: ONE ViT featurization batch for all P
        proposals, then per-pack score + lift. Same results as P estimate()
        calls. (The JAX version pads P to a power of two to avoid XLA
        recompiles; eager PyTorch has nothing to recompile.)"""
        qfs = normalize_feats(self.feature_fn(proposals))  # [P, G², D]
        k = self._f32(k)
        boxes = self._f32(boxes)
        est_scales = self._f32(est_scales)
        out = []
        for i, pack in enumerate(packs):
            tcos, scores, idx = score_and_lift(
                pack.feats, qfs[i], pack.pc_min, pack.pc_max, pack.pc_mean,
                pack.poses, k, boxes[i], est_scales[i], top_k,
            )
            out.append(PoseEstimate(tcos, scores, idx, None))
        return out
