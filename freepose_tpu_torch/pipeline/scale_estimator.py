"""Metric scale estimation: constant, depth-mean, and CLIP + LLM-prior kNN.

Counterpart of freepose_tpu.pipeline.scale_estimator:

  * ConstantScaleEstimator: a fixed half-extent;
  * MeanScaleEstimator: per-mask depth pointcloud extents, corrected so
    their mean matches a prior mean scale;
  * ClipPriorScaleEstimator: CLIP-embed each proposal, kNN (k = 11, median)
    against the text embeddings of the LLM prior's object names, optionally
    corrected by observed depth.

`depth_scales` runs each mask through the largest connected component,
adaptive erosion, depth outlier rejection, SVD alignment and the bbox
half-extent, on the depth's device.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.geometry.pointcloud import bbox_half_extent, pointcloud_from_mask
from freepose_tpu_torch.ops.connected_components import largest_component
from freepose_tpu_torch.ops.erosion import adaptive_erosion
from freepose_tpu_torch.ops.knn import knn_median_lookup


def depth_scales(depth: torch.Tensor, k: torch.Tensor, masks: torch.Tensor, svd: bool = True,
                 erosion_radius: int = 8, min_vertices: int = 25) -> torch.Tensor:
    """depth [H, W], k [3, 3], masks [N, H, W] -> per-mask pointcloud
    half-extent estimates [N]."""
    out = []
    for mask in masks:
        m = adaptive_erosion(largest_component(mask), erosion_radius, min_pixels=min_vertices)
        pts, valid = pointcloud_from_mask(depth, k, m, min_vertices=min_vertices, svd=svd)
        out.append(bbox_half_extent(pts, valid))
    return torch.stack(out)


def _depth_scales_np(depth, k, masks, svd: bool, device) -> np.ndarray:
    return depth_scales(torch.as_tensor(np.asarray(depth, np.float32), device=device),
                        torch.as_tensor(np.asarray(k, np.float32), device=device),
                        torch.as_tensor(masks, device=device), svd).cpu().numpy()


class ConstantScaleEstimator:
    def __init__(self, const: float):
        self.const = float(const)

    def estimate(self, proposals, depth=None, k=None) -> np.ndarray:
        n = len(proposals) if hasattr(proposals, "__len__") else 1
        return np.full(n, self.const, np.float32)


class MeanScaleEstimator:
    """Depth-derived scales, mean-corrected to a prior."""

    def __init__(self, mean_scale: float, svd: bool = True):
        self.mean_scale = mean_scale
        self.svd = svd

    def estimate(self, proposals, depth, k) -> np.ndarray:
        masks = proposals.full_masks
        scales = _depth_scales_np(depth, k, masks, self.svd, masks.device)
        return scales * (self.mean_scale / (2.0 * scales.mean()))


class ClipPriorScaleEstimator:
    """CLIP-kNN over LLM text-prior scales. `clip` is a ClipFeatureExtractor;
    `tokenize` maps list[str] -> int32 ids [N, L]. The prior's text
    features are built once and cached in `feats_path`, in the JAX package's
    .npz format."""

    def __init__(self, clip, tokenize, scale_file: str | Path | None = None, feats_path: str | Path | None = None,
                 query_k: int = 11, svd: bool = True):
        self.clip = clip
        self.query_k = query_k
        self.svd = svd
        if feats_path and Path(feats_path).exists():
            z = np.load(feats_path)
            text_features, scales = z["feats"], z["scales"]
        else:
            text_features, scales = self.build_text_features(scale_file, clip, tokenize)
            if feats_path:
                np.savez(feats_path, feats=text_features, scales=scales)
        self.text_features = torch.as_tensor(text_features, device=clip.device)
        self.scales = torch.as_tensor(scales, device=clip.device)

    @staticmethod
    def build_text_features(scale_file, clip, tokenize, batch: int = 256):
        with open(scale_file) as f:
            prior = json.load(f)
        names = list(prior.keys())
        scales = np.asarray([prior[n] for n in names], np.float32)
        feats = []
        for i in range(0, len(names), batch):
            f = clip.encode_text(tokenize(names[i:i + batch]))
            feats.append((f / torch.linalg.norm(f, dim=-1, keepdim=True)).float().cpu().numpy())
        return np.concatenate(feats), scales

    def estimate(self, proposals, depth=None, k=None) -> np.ndarray:
        use_depth = depth is not None and len(proposals) > 1
        feats = self.clip.encode_image(proposals.proposals)  # [N, 3, T, T]
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        k_eff = min(self.query_k, len(self.scales))  # tiny priors: clamp k
        prior_scales = knn_median_lookup(self.text_features, self.scales, feats, k_eff).cpu().numpy()
        if use_depth:
            masks = proposals.full_masks
            d_scales = _depth_scales_np(depth, k, masks, self.svd, masks.device)
            correction = np.median(prior_scales / np.maximum(d_scales, 1e-9))
            scales = d_scales * correction
        else:
            scales = prior_scales
        return scales / 2.0
