"""Proposal container: detection crops + masks, device-resident.

Counterpart of freepose_tpu.pipeline.proposals (`Proposals`,
`extract_proposals`, `proposals_from_masks_video`, `retrieve_topk`): the
N-proposal crop is one batched gather; RLE / BOP dict export happens at the
host boundary only.
"""
from __future__ import annotations

import dataclasses

import torch

from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.io.proposals_json import proposal_entry
from freepose_tpu_torch.utils import timing


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


def proposals_from_masks_video(
    frames: torch.Tensor,  # [K, H, W, 3] uint8 or float frames on the device
    masks: torch.Tensor,  # [K, H, W] bool (a propagate_batched batch's masks of one object)
    target_size: int = 420,
    bbox_extend: float = 0.2,
):
    """The coupled video step's mask -> bbox -> crop on the device for a
    batch of frames: each frame's bbox (mask_to_bbox), its masked RGB and
    mask cropped by crop_resize_pad, so SAM2's masks reach the refine chain
    with no fetch and no upload. An empty mask falls back to the centred
    half-frame box. Per frame equal to extract_proposals on that mask and
    bbox. Returns (crops [K, 3, T, T] f32, mask crops [K, T, T] bool,
    bboxes [K, 4] f32)."""
    from freepose_tpu_torch.geometry.boxes import mask_to_bbox

    with timing.span("proposals.video"):
        kf, h, w = masks.shape
        masks = masks.to(device=frames.device, dtype=torch.bool)
        empty = ~masks.reshape(kf, -1).any(dim=1)
        with timing.wait("proposals.fallback"):  # an upload from pageable memory synchronises
            fallback = torch.tensor([w * 0.25, h * 0.25, w * 0.75, h * 0.75], dtype=torch.float32,
                                    device=frames.device)
        bboxes = torch.where(empty[:, None], fallback, mask_to_bbox(masks).to(torch.float32))
        img = frames.to(torch.float32)
        if frames.dtype == torch.uint8:
            img = img / 255.0
        rgb = torch.where(masks[:, None], img.permute(0, 3, 1, 2), torch.zeros((), device=frames.device))
        crops = crop_resize_pad(rgb, bboxes, target_size, extend=bbox_extend)
        mask_crops = crop_resize_pad(masks[:, None].to(torch.float32), bboxes, target_size,
                                     extend=bbox_extend)[:, 0] > 0.5
        return crops, mask_crops, bboxes


def retrieve_topk(
    image: torch.Tensor,  # [H, W, 3]
    masks: torch.Tensor,  # [N, H, W] bool
    boxes: torch.Tensor,  # [N, 4] xyxy
    bank: torch.Tensor,  # [M, D] L2-normalised retrieval bank
    extractor,  # DinoFeatureExtractor
    layer: int,
    feature_type: str = "ffa",
    k: int = 100,
    target_size: int = 420,
    bbox_extend: float = 0.1,
):
    """A frame's retrieval: proposal crops, DINOv2 features at `layer`, FFA
    pooling of the patch tokens (or the normalised cls token), and the bank
    top-k (ties to the lower row). The proposal count is padded to the next
    power of two (empty masks, the last box repeated), as the JAX function
    pads it, so that a frame's detection count reuses a few crop batches;
    results are sliced back to N. Returns (scores [N, k], indices [N, k],
    features [N, D]) on the extractor's device."""
    from freepose_tpu_torch.ops.knn import topk_search
    from freepose_tpu_torch.ops.sampling import ffa_pool
    from freepose_tpu_torch.pipeline.template_bank import normalize_feats

    dev = extractor.device
    image, masks = torch.as_tensor(image, device=dev), torch.as_tensor(masks, device=dev)
    boxes = torch.as_tensor(boxes, device=dev)
    n = masks.shape[0]
    n_pad = 1 << max(n - 1, 0).bit_length()
    if n_pad != n:
        masks = torch.cat([masks, torch.zeros((n_pad - n,) + masks.shape[1:], dtype=masks.dtype, device=dev)])
        boxes = torch.cat([boxes, boxes[-1:].expand(n_pad - n, -1)])
    prop = extract_proposals(image, masks, boxes, target_size, bbox_extend)
    if feature_type == "cls":
        feats = normalize_feats(extractor(prop.proposals, layer=layer, feature_type="cls").float())
    else:
        patch = extractor(prop.proposals, layer=layer, feature_type="patch")
        feats = ffa_pool(patch.float(), prop.masks, grid=target_size // extractor.config.patch_size)
    scores, idx = topk_search(bank, feats, k)
    return scores[:n], idx[:n], feats[:n]
