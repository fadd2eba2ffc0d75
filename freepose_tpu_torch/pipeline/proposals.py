"""Proposal container: detection crops + masks, device-resident.

Counterpart of freepose_tpu.pipeline.proposals (`Proposals`,
`extract_proposals`): the N-proposal crop is one batched gather; RLE / BOP
dict export happens at the host boundary only.
"""
from __future__ import annotations

import dataclasses

import torch

from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.io.proposals_json import proposal_entry


@dataclasses.dataclass
class Proposals:
    """proposals: [N, 3, T, T] masked RGB crops; masks: [N, T, T] bool crops
    of the detection masks; boxes: [N, 4] xyxy (int); full_masks: [N, H, W]."""

    proposals: torch.Tensor
    masks: torch.Tensor
    boxes: torch.Tensor
    full_masks: torch.Tensor
    scene_id: int | None = None
    frame_id: int | None = None
    scores: list = dataclasses.field(default_factory=list)
    meshes: list = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return int(self.boxes.shape[0])

    def to_bop_dicts(self, time: float = 0.01) -> list[dict]:
        boxes = self.boxes.cpu().numpy()
        masks = self.full_masks.cpu().numpy()
        return [
            proposal_entry(
                boxes[i], masks[i], self.meshes[i], self.scores[i],
                self.scene_id or 0, self.frame_id or 0, time=time,
            )
            for i in range(len(self))
        ]


def extract_proposals(
    image: torch.Tensor,  # [H, W, 3] uint8 or float in [0,1]
    masks: torch.Tensor,  # [N, H, W] bool
    boxes: torch.Tensor,  # [N, 4] xyxy
    target_size: int = 420,
    bbox_extend: float = 0.2,
    mask_rgb: bool = True,
    scene_id: int | None = None,
    frame_id: int | None = None,
) -> Proposals:
    """Crop each detection to a square target."""
    img = image.to(torch.float32)
    if image.dtype == torch.uint8:
        img = img / 255.0
    chw = img.permute(2, 0, 1)  # [3, H, W]
    n = masks.shape[0]
    masks = masks.to(device=image.device, dtype=torch.bool)
    boxes = torch.as_tensor(boxes, device=image.device)
    if mask_rgb:
        rgb = torch.where(masks[:, None], chw[None], torch.zeros((), device=image.device))
    else:
        rgb = chw.expand((n,) + chw.shape)
    crops = crop_resize_pad(rgb, boxes, target_size, extend=bbox_extend)
    mask_crops = crop_resize_pad(
        masks[:, None].to(torch.float32), boxes, target_size, extend=bbox_extend
    )[:, 0] > 0.5
    return Proposals(
        proposals=crops,
        masks=mask_crops,
        boxes=torch.floor(boxes.to(torch.float32)).to(torch.int32),
        full_masks=masks,
        scene_id=scene_id,
        frame_id=frame_id,
    )

