"""DINOv2 ViT with register tokens, as an nn.Module.

Counterpart of freepose_tpu.models.dinov2: ViT-L/14-reg for retrieval and
pose scoring (truncated at block 22 of 24), ViT-B/14-reg for the tracking
refiner. Tokens = [cls, reg×4, patches]; position embeddings cover cls and
patches only, bicubically resampled for non-native grids. The cls, register
and position tokens stay fp32 and are added before the cast to the compute
dtype, as in the JAX model; everything else runs in `config.dtype`.

A single image on a card, under inference mode, is launch-bound: some
hundreds of kernels of microseconds each. From the second call of its key
(image size, dtype, depth, device, attention functions) on, `DinoV2.forward`
replays the forward as one CUDA graph (_ForwardGraph, utils/cuda_graphs.py)
instead, the same kernels in the same order; batches above one and the CPU
run eagerly.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from freepose_tpu_torch.models.vit import TransformerBlock, interpolate_pos_embed
from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import GraphCache, capture

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 518  # native grid the position embeddings were trained at
    num_registers: int = 4
    mlp_ratio: float = 4.0
    dtype: torch.dtype = torch.float32

    @property
    def native_grid(self) -> int:
        return self.image_size // self.patch_size


VIT_L14_REG = DinoV2Config()
VIT_B14_REG = DinoV2Config(hidden_size=768, num_layers=12, num_heads=12)
VIT_S14_REG = DinoV2Config(hidden_size=384, num_layers=12, num_heads=6)
# Tiny config for tests.
VIT_TEST = DinoV2Config(hidden_size=64, num_layers=3, num_heads=4, image_size=56)


class _ForwardGraph:
    """One key's forward as a CUDA graph over a static input buffer. A call
    copies its images into the buffer, replays, counts
    `dinov2.graph_replays` and returns a copy of the static output, which
    the next replay overwrites."""

    def __init__(self, model: "DinoV2", images: torch.Tensor, n_layers: int):
        self.images = images.clone(memory_format=torch.contiguous_format)

        def forward():
            self.out = model._forward(self.images, n_layers)

        self.graph, = capture(images.device, forward, forward)
        timing.count("dinov2.graph_captures")

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        self.images.copy_(images)
        self.graph.replay()
        timing.count("dinov2.graph_replays")
        return self.out.clone()


class DinoV2(nn.Module):
    """Returns all-token features after block `layer` + final norm. Only the
    first `layer` blocks run."""

    def __init__(self, config: DinoV2Config):
        super().__init__()
        self._graphs = GraphCache()
        cfg = self.config = config
        d = cfg.hidden_size
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, dtype=cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.reg_tokens = nn.Parameter(torch.zeros(1, cfg.num_registers, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.native_grid**2, d))
        self.blocks = nn.ModuleList(
            TransformerBlock(d, cfg.num_heads, cfg.mlp_ratio, layerscale=True, dtype=cfg.dtype)
            for _ in range(cfg.num_layers)
        )
        self.norm = nn.LayerNorm(d, eps=1e-6, dtype=cfg.dtype)

    def forward(self, images: torch.Tensor, layer: Optional[int] = None) -> torch.Tensor:
        """images: [B, 3, H, W], ImageNet-normalized. -> [B, 1+R+N, D]. A
        single image on a card under inference mode replays its key's CUDA
        graph from the key's second call on (_ForwardGraph)."""
        n_layers = layer if layer is not None else self.config.num_layers
        graph = self._graph(images, n_layers)
        return self._forward(images, n_layers) if graph is None else graph(images)

    def _graph(self, images: torch.Tensor, n_layers: int) -> Optional[_ForwardGraph]:
        """The CUDA graph of this call's key, or None (eager). The key holds
        what a replay depends on and a call can see: the image size, dtype,
        depth and device, and each block's attention function, so a swapped
        function never replays the former one."""
        if images.shape[0] != 1 or images.device.type != "cuda" or not torch.is_inference_mode_enabled():
            return None
        key = (tuple(images.shape[2:]), images.dtype, n_layers, images.device,
               tuple(blk.attn.attention_fn for blk in self.blocks))
        return self._graphs.get(key, lambda: _ForwardGraph(self, images, n_layers))

    def _apply(self, fn, *args, **kwargs):
        self._graphs.clear()  # a graph replays the parameter tensors of its capture
        return super()._apply(fn, *args, **kwargs)

    def _forward(self, images: torch.Tensor, n_layers: int) -> torch.Tensor:
        cfg = self.config
        b, _, h, w = images.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size

        x = self.patch_embed(images.to(cfg.dtype)).flatten(2).transpose(1, 2)  # [B, gh*gw, D]
        patch_pos = interpolate_pos_embed(self.pos_embed[:, 1:], (gh, gw), cfg.native_grid)
        x = x + patch_pos.to(cfg.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(cfg.dtype)
        x = torch.cat(
            [cls.expand(b, -1, -1), self.reg_tokens.to(cfg.dtype).expand(b, -1, -1), x], dim=1
        )
        for blk in self.blocks[:n_layers]:
            x = blk(x)
        return self.norm(x)


def imagenet_stats(dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std as [1, 3, 1, 1] tensors of `dtype` on
    `device` (an upload from pageable memory, which synchronises: made once)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=device).reshape(1, 3, 1, 1)
    return mean, std


def normalize_images(images: torch.Tensor, stats: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> ImageNet-normalized by `stats`
    (imagenet_stats of the images' dtype and device)."""
    mean, std = stats
    return (images - mean) / std


def split_tokens(tokens: torch.Tensor, num_registers: int = 4) -> dict:
    return {
        "cls": tokens[:, 0],
        "reg": tokens[:, 1 : 1 + num_registers],
        "patch": tokens[:, 1 + num_registers :],
    }


def init_random_(model: DinoV2, generator: torch.Generator) -> DinoV2:
    """Seeded random init in the JAX model's scheme: lecun-normal kernels,
    zero biases, unit LayerNorm, LayerScale 1e-5, pos_embed N(0, 0.02),
    zero cls/register tokens."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "pos_embed":
                vals = torch.randn(p.shape, generator=generator) * 0.02
            elif name in ("cls_token", "reg_tokens") or leaf == "bias":
                vals = torch.zeros(p.shape)
            elif leaf == "gamma":
                vals = torch.full(p.shape, 1e-5)
            elif p.ndim == 1:  # LayerNorm weight
                vals = torch.ones(p.shape)
            else:  # Linear [out, in] / Conv [out, in, kh, kw]
                fan_in = math.prod(p.shape[1:])
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            p.copy_(vals)
    return model


class DinoFeatureExtractor:
    """Feature-extraction front end: normalize, run to `layer`, final norm,
    select cls / reg / patch tokens.

    params: the JAX package's DINOv2 parameter tree (nested dicts of numpy
    arrays, as scripts' load_params returns), converted with
    models/convert.py:dinov2_from_jax; None gives a seeded random init.
    Runs on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: DinoV2Config = VIT_L14_REG, params=None, seed: int = 0,
                 device: str | torch.device | None = None):
        from freepose_tpu_torch.device import resolve_device

        self.config = config
        self.device = resolve_device(device)
        model = DinoV2(config)
        if params is None:
            init_random_(model, torch.Generator().manual_seed(seed))
        else:
            from freepose_tpu_torch.models.convert import dinov2_from_jax

            model.load_state_dict(dinov2_from_jax(params))
        self.model = model.to(self.device).eval()
        self.stats = imagenet_stats(config.dtype, self.device)  # resident: no upload in front of a forward

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, layer: int = 22, feature_type: str = "patch") -> torch.Tensor:
        images = images.to(self.device)
        tokens = self.model(normalize_images(images.to(self.config.dtype), self.stats), layer=layer)
        return split_tokens(tokens, self.config.num_registers)[feature_type]

    def replica(self, device) -> "DinoFeatureExtractor":
        """This extractor on `device`: itself where it already runs there,
        else a copy with the model's weights and normalization constants
        copied over, and no CUDA graph (parallel/mesh.py:replicate)."""
        device = torch.device(device)
        if next(self.model.parameters()).device == device:
            return self
        out = copy.copy(self)
        out.device = device
        out.model = copy.deepcopy(self.model).to(device)
        out.stats = tuple(s.to(device) for s in self.stats)
        return out

    def extract_sharded(self, images: torch.Tensor, layer: int = 22, feature_type: str = "patch",
                        mesh=None) -> torch.Tensor:
        """Data-parallel extraction: the batch split over the mesh's "data"
        axis (padded with zero images to a multiple of it), each block
        through this model's replica on its shard's device, the features
        gathered on mesh.first -> [B, ...]. mesh=None: every CUDA card on
        "data"."""
        from freepose_tpu_torch.parallel.mesh import gather, make_mesh, replicate, split

        if mesh is None:
            mesh = make_mesh(data=torch.cuda.device_count(), model=1)
        n = images.shape[0]
        pad = (-n) % mesh.shape["data"]
        if pad:
            images = torch.cat([images, images.new_zeros((pad,) + tuple(images.shape[1:]))])
        replicas = replicate(self, mesh)
        parts = [replicas[x.device](x, layer=layer, feature_type=feature_type) for x in split(images, mesh, "data")]
        return gather(parts, mesh)[:n]
