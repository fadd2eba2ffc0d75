"""SAM2 prompt encoder: point, box and mask prompts, as nn.Modules.

Counterpart of freepose_tpu.models.sam2.prompt, with the random Fourier
positional embedding. Label convention: 1 positive, 0 negative, -1
not-a-point, 2/3 box corners, -10 padding.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from benchmark.reference.frozen.layers import Conv, LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class PromptConfig:
    hidden_size: int = 256
    image_size: int = 1024
    patch_size: int = 16
    mask_input_channels: int = 16
    num_point_embeddings: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def embed_grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def mask_input_size(self) -> int:
        return 4 * self.image_size // self.patch_size


def fourier_point_embedding(coords01: torch.Tensor, pe_matrix: torch.Tensor) -> torch.Tensor:
    """[..., 2] coords in [0, 1] and a [2, D/2] Fourier matrix -> [..., D]."""
    proj = ((2.0 * coords01 - 1.0) @ pe_matrix) * (2.0 * math.pi)
    return torch.cat([proj.sin(), proj.cos()], dim=-1)


class ChannelLayerNorm(LayerNorm):
    """LayerNorm over the channel axis of NHWC data."""


class MaskEmbedding(nn.Module):
    def __init__(self, cfg: PromptConfig):
        super().__init__()
        c, dt = cfg.mask_input_channels, cfg.dtype
        self.conv1 = Conv(1, c // 4, 2, stride=2, dtype=dt)
        self.ln1 = LayerNorm(c // 4, dtype=dt)
        self.conv2 = Conv(c // 4, c, 2, stride=2, dtype=dt)
        self.ln2 = LayerNorm(c, dtype=dt)
        self.conv3 = Conv(c, cfg.hidden_size, 1, dtype=dt)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """[B, 1, 4G, 4G] mask logits -> [B, G, G, D] dense embeddings."""
        x = gelu(self.ln1(self.conv1(masks.permute(0, 2, 3, 1))))
        x = gelu(self.ln2(self.conv2(x)))
        return self.conv3(x)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: PromptConfig):
        super().__init__()
        self.cfg = cfg
        self.pe_matrix = nn.Parameter(torch.zeros(2, cfg.hidden_size // 2))
        self.point_embed = nn.Parameter(torch.zeros(cfg.num_point_embeddings, cfg.hidden_size))
        self.not_a_point = nn.Parameter(torch.zeros(1, cfg.hidden_size))
        self.no_mask = nn.Parameter(torch.zeros(1, cfg.hidden_size))
        self.mask_embed = MaskEmbedding(cfg)

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points [B, P, N, 2] pixel coords; labels [B, P, N] -> [B, P, N, D]."""
        c = self.cfg
        pe = fourier_point_embedding((points.float() + 0.5) / c.image_size, self.pe_matrix).to(c.dtype)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point[0].to(c.dtype), pe)
        pe = torch.where(lab == -10, torch.zeros((), dtype=c.dtype, device=pe.device), pe)
        typed = self.point_embed[torch.clamp(labels, min=0)].to(c.dtype)
        return pe + typed * (lab >= 0).to(c.dtype)

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [B, P, 4] xyxy -> [B, P, 3, D] (2 corners + a pad point)."""
        c = self.cfg
        corners = (boxes.float().reshape(*boxes.shape[:2], 2, 2) + 0.5) / c.image_size
        pe = fourier_point_embedding(corners, self.pe_matrix).to(c.dtype)
        pe = torch.stack([pe[:, :, 0] + self.point_embed[2].to(c.dtype),
                          pe[:, :, 1] + self.point_embed[3].to(c.dtype)], dim=2)
        pad = self.not_a_point[0].to(c.dtype).expand_as(pe[:, :, :1])
        return torch.cat([pe, pad], dim=2)

    def dense_embedding(self, batch: int, masks: torch.Tensor | None) -> torch.Tensor:
        """-> [B, G, G, D]: the mask embedding, or the learned no-mask one.
        Per-prompt masks [B, P, 1, 4G, 4G] give [B, P, G, G, D]."""
        c = self.cfg
        if masks is not None:
            if masks.ndim == 5:
                b, p = masks.shape[:2]
                emb = self.mask_embed(masks.reshape(b * p, *masks.shape[2:]))
                return emb.reshape(b, p, *emb.shape[1:])
            return self.mask_embed(masks)
        g = c.embed_grid
        return self.no_mask[0].to(c.dtype).expand(batch, g, g, c.hidden_size)

    def forward(self, points=None, labels=None, boxes=None, masks=None):
        sparse = None
        batch = 1
        if points is not None:
            batch = points.shape[0]
            if boxes is None:  # pad with one not-a-point (the reference's pad=True)
                points = torch.nn.functional.pad(points, (0, 0, 0, 1))
                labels = torch.nn.functional.pad(labels, (0, 1), value=-1)
            sparse = self.embed_points(points, labels)
        if boxes is not None:
            batch = boxes.shape[0]
            be = self.embed_boxes(boxes)
            sparse = be if sparse is None else torch.cat([sparse, be], dim=2)
        return sparse, self.dense_embedding(batch, masks)

    def image_wide_pe(self) -> torch.Tensor:
        """[G, G, D] Fourier PE over the embedding grid."""
        g = self.cfg.embed_grid
        dev = self.pe_matrix.device
        y = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        x = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        return fourier_point_embedding(torch.stack([xx, yy], dim=-1), self.pe_matrix)
