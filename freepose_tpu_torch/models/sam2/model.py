"""SAM2 image model: Hiera encoder + prompt encoder + mask decoder.

Counterpart of freepose_tpu.models.sam2.model: embed an image once, then
decode any number of point / box / mask prompts against the cached pyramid.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from freepose_tpu_torch.models.sam2.hiera import HIERA_L, FpnNeck, Hiera, HieraConfig
from freepose_tpu_torch.models.layers import Conv
from freepose_tpu_torch.models.sam2.mask_decoder import MaskDecoder, MaskDecoderConfig
from freepose_tpu_torch.models.sam2.prompt import PromptConfig, PromptEncoder
from freepose_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class Sam2Config:
    hiera: HieraConfig = HIERA_L
    prompt: PromptConfig = PromptConfig()
    decoder: MaskDecoderConfig = MaskDecoderConfig()
    fpn_dim: int = 256
    dtype: torch.dtype = torch.float32


# The JAX package's tiny image config (its image-predictor tests and
# FREEPOSE_TINY_MODELS runs of the static proposal CLI, at 64²).
SAM2_TEST = Sam2Config(
    hiera=HieraConfig(
        embed_dim=8, blocks_per_stage=(1, 1, 1, 1), embed_dim_per_stage=(8, 16, 32, 64),
        heads_per_stage=(1, 2, 4, 8), window_size_per_stage=(4, 4, 4, 4),
        global_attention_blocks=(9,), window_pos_bg_size=(2, 2),
    ),
    prompt=PromptConfig(hidden_size=16, image_size=64, patch_size=16, mask_input_channels=4),
    decoder=MaskDecoderConfig(hidden_size=16, num_heads=2, mlp_dim=32, iou_head_hidden=16),
    fpn_dim=16,
)

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def sam2_normalize(images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> normalised."""
    with timing.wait("sam2.normalize"):  # uploads from pageable memory synchronise
        mean = torch.tensor(IMAGE_MEAN, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
        std = torch.tensor(IMAGE_STD, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
    return (images - mean) / std


class Sam2ImageModel(nn.Module):
    def __init__(self, config: Sam2Config):
        super().__init__()
        c = self.config = config
        self.backbone = Hiera(c.hiera)
        self.neck = FpnNeck(tuple(c.hiera.embed_dim_per_stage), fpn_dim=c.fpn_dim, dtype=c.dtype)
        self.prompt_encoder = PromptEncoder(c.prompt)
        self.decoder = MaskDecoder(c.decoder)
        self.no_memory_embedding = nn.Parameter(torch.zeros(1, 1, c.fpn_dim))
        # High-res skip projections, applied once per image.
        self.conv_s0 = Conv(c.fpn_dim, c.decoder.hidden_size // 8, 1, dtype=c.dtype)
        self.conv_s1 = Conv(c.fpn_dim, c.decoder.hidden_size // 4, 1, dtype=c.dtype)

    def embed_image(self, pixels: torch.Tensor, with_memory_placeholder: bool = True):
        """[B, 3, H, W] normalised pixels -> pyramid [s0, s1, s2] (NHWC) and
        their sine position encodings."""
        feats, pos = self.raw_pyramid(pixels)
        s0 = self.conv_s0(feats[0])
        s1 = self.conv_s1(feats[1])
        s2 = feats[2]
        if with_memory_placeholder:
            s2 = s2 + self.no_memory_embedding[0, 0].to(s2.dtype)
        return [s0, s1, s2], pos

    def raw_pyramid(self, pixels: torch.Tensor):
        """Backbone + neck features without the SAM-head projections."""
        return self.neck(self.backbone(pixels))

    def decode_masks(self, pyramid, points=None, labels=None, boxes=None, mask_inputs=None,
                     multimask_output: bool = True):
        """Prompt + decode against a cached pyramid. Returns (low-res masks
        [B, P, M, 4G, 4G], iou [B, P, M], sam tokens [B, P, M, D], object
        logits [B, P, 1])."""
        s0, s1, s2 = pyramid
        b = s2.shape[0]
        if points is None and boxes is None:
            points = torch.zeros((b, 1, 1, 2), dtype=torch.float32, device=s2.device)
            labels = -torch.ones((b, 1, 1), dtype=torch.int64, device=s2.device)
        if points is not None and labels is None:
            labels = torch.ones(points.shape[:3], dtype=torch.int64, device=points.device)
        sparse, dense = self.prompt_encoder(points, labels, boxes, mask_inputs)
        image_pe = self.prompt_encoder.image_wide_pe()
        return self.decoder(s2, image_pe, sparse, dense, (s0, s1), multimask_output)

    def forward(self, pixels, points=None, labels=None, boxes=None, mask_inputs=None, multimask_output=True):
        pyramid, _ = self.embed_image(pixels)
        return self.decode_masks(pyramid, points, labels, boxes, mask_inputs, multimask_output)
