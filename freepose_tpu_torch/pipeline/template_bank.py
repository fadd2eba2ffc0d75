"""Per-mesh template packs: features + pointcloud statistics, device-cached.

Counterpart of freepose_tpu.pipeline.template_bank. Each mesh reduces once
to a compact pack: `feats` [V, G², D] L2-normalized patch features (the
scoring operand) and `pc_min/pc_max/pc_mean` [V, 3], the per-view pointcloud
statistics the z-lift consumes. Packs live in an LRU dict of device tensors
with an optional .npz disk tier whose keys and fp16 `feats` match the JAX
package's, so each package reads the other's packs.

Tracing (utils/timing.py) sees a pack built from its mesh as the span
`template_bank.build` (the render, the features and the depth statistics)
and counts `template_bank.packs_built` and `template_bank.views`.
"""
from __future__ import annotations

import dataclasses
import os
import zipfile
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.geometry.camera import backproject_depth
from freepose_tpu_torch.geometry.pointcloud import masked_mean
from freepose_tpu_torch.pipeline.renderer import TemplateRenderer, template_intrinsics
from freepose_tpu_torch.utils import timing


@dataclasses.dataclass
class TemplatePack:
    name: str
    feats: torch.Tensor  # [V, G*G, D] normalized patch features
    pc_min: torch.Tensor  # [V, 3]
    pc_max: torch.Tensor  # [V, 3]
    pc_mean: torch.Tensor  # [V, 3]
    poses: torch.Tensor  # [V, 4, 4]


def depth_stats(depths: torch.Tensor, k: torch.Tensor, chunk: int = 64):
    """[V, H, W] depths -> per-view pointcloud (min, max, mean) [V, 3] each.
    `k` is [3, 3] or per-view [V, 3, 3]. An empty view gives a zero-extent
    cloud at the origin. Views run `chunk` at a time to bound memory."""
    outs = []
    for s in range(0, depths.shape[0], chunk):
        d = depths[s : s + chunk]
        kk = k if k.ndim == 2 else k[s : s + chunk]
        pts, valid = backproject_depth(d, kk)  # [C, HW, 3], [C, HW]
        with timing.wait("template_bank.depth_stats"):  # an upload from pageable memory synchronises
            big = torch.tensor(1e30, dtype=pts.dtype, device=pts.device)
        vmin = torch.where(valid[..., None], pts, big).amin(dim=1)
        vmax = torch.where(valid[..., None], pts, -big).amax(dim=1)
        mean = masked_mean(pts, valid, axis=1)
        any_valid = valid.any(dim=1, keepdim=True)
        zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
        outs.append((torch.where(any_valid, vmin, zero), torch.where(any_valid, vmax, zero), mean))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def depth_stats_per_k(depths: torch.Tensor, ks: torch.Tensor):
    """depth_stats with per-view intrinsics [V, 3, 3] (the zoomed-render
    path): the backprojected cloud is the same object geometry whichever
    zoom rendered it, so the z-lift takes these stats unchanged."""
    return depth_stats(depths, ks)


def normalize_feats(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True).clamp(min=1e-12)


class TemplateBank:
    """Builds and caches TemplatePacks.

    `feature_fn(images [B,3,T,T]) -> [B, G², D]` is the DINOv2 patch
    extractor (already layer-truncated); `renderer` renders the pose grid.
    """

    def __init__(
        self,
        feature_fn,
        renderer: TemplateRenderer | None = None,
        cache_size: int = 4,
        cache_dir: str | Path | None = None,
        batch_size: int = 128,
        device: str | torch.device | None = None,
    ):
        self.feature_fn = feature_fn
        self.renderer = renderer or TemplateRenderer(device=device)
        self.cache: OrderedDict[str, TemplatePack] = OrderedDict()
        self.cache_size = cache_size
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.batch_size = batch_size
        self.k = self.renderer.k
        self.device = self.k.device

    def _extract_feats(self, images: torch.Tensor) -> torch.Tensor:
        outs = [self.feature_fn(images[i : i + self.batch_size])
                for i in range(0, images.shape[0], self.batch_size)]
        return normalize_feats(torch.cat(outs))

    def build_pack(self, name: str, mesh) -> TemplatePack:
        with timing.span("template_bank.build"):
            rgb, depth = self.renderer.render(mesh)
            props, _, _ = self.renderer.generate_proposals(rgb, depth)
            feats = self._extract_feats(props)
            pc_min, pc_max, pc_mean = depth_stats(depth, self.k)
            timing.count("template_bank.packs_built")
            timing.count("template_bank.views", int(depth.shape[0]))
        return TemplatePack(name, feats, pc_min, pc_max, pc_mean, self.renderer.poses)

    def pack_from_views(self, name: str, images: torch.Tensor, depths: torch.Tensor,
                        poses: torch.Tensor, k=None) -> TemplatePack:
        """Build a pack from pre-rendered views (e.g. template shards)."""
        feats = self._extract_feats(images)
        k = k if k is not None else template_intrinsics(device=depths.device)
        pc_min, pc_max, pc_mean = depth_stats(depths, k)
        return TemplatePack(name, feats, pc_min, pc_max, pc_mean, poses)

    def get(self, name: str, mesh=None) -> TemplatePack:
        if name in self.cache:
            self.cache.move_to_end(name)
            return self.cache[name]
        pack = self._load_disk(name)
        if pack is None:
            if mesh is None:
                raise KeyError(f"template pack {name!r} not cached and no mesh given")
            pack = self.build_pack(name, mesh)
            self._save_disk(pack)
        self.cache[name] = pack
        if len(self.cache) > self.cache_size:
            self.cache.popitem(last=False)
        return pack

    def _disk_path(self, name: str) -> Path | None:
        return self.cache_dir / f"{name}.npz" if self.cache_dir else None

    def _save_disk(self, pack: TemplatePack) -> None:
        path = self._disk_path(pack.name)
        if path and not path.exists():
            # Atomic publish: concurrent shard workers only see complete files.
            tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
            np.savez(
                tmp,
                feats=pack.feats.float().cpu().numpy().astype(np.float16),
                pc_min=pack.pc_min.cpu().numpy(),
                pc_max=pack.pc_max.cpu().numpy(),
                pc_mean=pack.pc_mean.cpu().numpy(),
                poses=pack.poses.cpu().numpy(),
            )
            os.replace(tmp, path)

    def _load_disk(self, name: str) -> TemplatePack | None:
        path = self._disk_path(name)
        if not path or not path.exists():
            return None
        keys = ("feats", "pc_min", "pc_max", "pc_mean", "poses")
        try:
            with np.load(path) as z:
                arrays = {k: z[k] for k in keys}
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
            return None  # truncated/corrupt cache entry -> rebuild
        arrays["feats"] = arrays["feats"].astype(np.float32)
        return TemplatePack(name, *(torch.as_tensor(arrays[k], device=self.device) for k in keys))
