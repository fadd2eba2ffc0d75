"""SAM2 automatic mask generation: grid-prompted whole-image segmentation.

Counterpart of freepose_tpu.models.sam2.automatic.Sam2AutomaticMaskGenerator
(the reference's SAM2AutomaticMaskGenerator): prompt a point grid over the
image (and over each crop layer's crops), decode multimask predictions per
point, keep those whose predicted IoU and stability pass and whose box does
not touch a crop edge, deduplicate with box NMS, and emit records with a
binary mask or an uncompressed RLE.

Each batch of `points_per_batch` points runs on the predictor's device:
decode, the full-resolution upsample, stability, binarisation and boxes;
the last batch is padded to the same size and its padded rows dropped. The
keep decisions, RLE, NMS and the small-region cleanup are data-dependent
work on few candidates and run on the host, as in the JAX package; only
the kept masks leave the device, as bool (the port does not bit-pack).
With use_m2m every candidate is decoded again with its own low-res mask as
a dense prompt (PromptEncoder.dense_embedding), which needs the predictor's
mask-prompt encoder.
"""
from __future__ import annotations

import numpy as np
import torch

from freepose_tpu_torch.geometry.boxes import nms_xyxy
from freepose_tpu_torch.io.rle import decode_rle, encode_rle, rle_area
from freepose_tpu_torch.models.sam2.amg import (
    batched_mask_to_box,
    build_all_layer_point_grids,
    calculate_stability_score,
    generate_crop_boxes,
    is_box_near_crop_edge,
)
from freepose_tpu_torch.models.sam2.predictor import Sam2ImagePredictor, scale_coords
from freepose_tpu_torch.ops.connected_components import remove_small_components
from freepose_tpu_torch.ops.sampling import resize_bilinear


class Sam2AutomaticMaskGenerator:
    """Masks for a whole image from a point grid. `generate(image)` returns
    records with the reference's keys: segmentation (bool [H, W] or an RLE
    dict), area, bbox (xywh), predicted_iou, point_coords, stability_score,
    crop_box (xywh). Runs on the predictor's device."""

    def __init__(
        self,
        predictor: Sam2ImagePredictor,
        points_per_side: int | None = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.8,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        mask_threshold: float = 0.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: list[np.ndarray] | None = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        use_m2m: bool = False,
        multimask_output: bool = True,
    ) -> None:
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("exactly one of points_per_side / point_grids")
        if output_mode not in ("binary_mask", "uncompressed_rle"):
            raise ValueError(f"output_mode {output_mode!r}: binary_mask or uncompressed_rle")
        if use_m2m and not predictor.has_mask_prompt_encoder:
            raise ValueError("use_m2m needs the mask-prompt encoder, which these SAM2 parameters lack")
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(points_per_side, crop_n_layers,
                                                           crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        self.predictor = predictor
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.use_m2m = use_m2m
        self.multimask_output = multimask_output

    # -- public API ---------------------------------------------------------

    def generate(self, image: np.ndarray) -> list[dict]:
        """image [H, W, 3] uint8 (or float 0-255) -> list of mask records."""
        data = self._generate_masks(np.asarray(image))
        records = []
        for i in range(len(data["rles"])):
            rle = data["rles"][i]
            seg = rle if self.output_mode == "uncompressed_rle" else decode_rle(rle)
            x0, y0, x1, y1 = data["boxes"][i]
            cx0, cy0, cx1, cy1 = data["crop_boxes"][i]
            records.append({
                "segmentation": seg,
                "area": rle_area(rle),
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "predicted_iou": float(data["iou_preds"][i]),
                "point_coords": [data["points"][i].tolist()],
                "stability_score": float(data["stability_score"][i]),
                "crop_box": [float(cx0), float(cy0), float(cx1 - cx0), float(cy1 - cy0)],
            })
        return records

    # -- on the device ------------------------------------------------------

    @torch.inference_mode()
    def _decode(self, pyramid, points_px: torch.Tensor, out_hw: tuple[int, int], multimask: bool,
                mask_inputs: torch.Tensor | None = None):
        """points_px [P, 2] in crop pixels -> (masks [P, M, h, w] bool,
        low-res logits [P, M, g, g], iou [P, M], stability [P, M], boxes
        [P, M, 4] xyxy); mask_inputs [P, 1, g', g'] are per-point dense
        prompts."""
        pts = scale_coords(points_px[None, :, None, :], out_hw, self.predictor.image_size)
        masks_in = None if mask_inputs is None else mask_inputs[None]
        low, iou, _, _ = self.predictor.model.decode_masks(pyramid, points=pts, mask_inputs=masks_in,
                                                           multimask_output=multimask)
        logits = resize_bilinear(low[0], out_hw)
        stab = calculate_stability_score(logits, self.mask_threshold, self.stability_score_offset)
        masks = logits > self.mask_threshold
        return masks, low[0], iou[0].float(), stab, batched_mask_to_box(masks)

    # -- internals ----------------------------------------------------------

    def _generate_masks(self, image: np.ndarray) -> dict:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        data = _cat([self._process_crop(image, box, layer, orig_size) for box, layer in zip(crop_boxes, layer_idxs)])
        if len(crop_boxes) > 1 and len(data["rles"]) > 0:
            # Masks of smaller crops win.
            areas = ((data["crop_boxes"][:, 2] - data["crop_boxes"][:, 0]) *
                     (data["crop_boxes"][:, 3] - data["crop_boxes"][:, 1]))
            keep = nms_xyxy(data["boxes"], 1.0 / np.maximum(areas, 1), self.crop_nms_thresh)
            data = _filter(data, keep)
        if self.min_mask_region_area > 0:
            data = self._postprocess_small_regions(data, self.min_mask_region_area,
                                                   max(self.box_nms_thresh, self.crop_nms_thresh))
        return data

    @torch.inference_mode()
    def _process_crop(self, image: np.ndarray, crop_box: list[int], layer_idx: int, orig_size: tuple) -> dict:
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1]
        crop_hw = crop.shape[:2]
        self.predictor.set_image(np.ascontiguousarray(crop))
        pyramid = self.predictor._pyramid
        points = self.point_grids[layer_idx] * np.array(crop_hw)[None, ::-1]
        parts = []
        bs = self.points_per_batch
        for s in range(0, len(points), bs):
            chunk = points[s:s + bs].astype(np.float32)
            pad = bs - len(chunk)  # one batch shape for every batch of the crop
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            part = self._process_batch(chunk, pyramid, crop_hw, crop_box, orig_size)
            if pad:
                part = _filter(part, np.nonzero(part["points_idx"] < bs - pad)[0])
            parts.append(part)
        data = _cat(parts)
        data.pop("points_idx", None)
        if len(data["rles"]) > 0:
            data = _filter(data, nms_xyxy(data["boxes"], data["iou_preds"], self.box_nms_thresh))
        off = np.array([x0, y0, x0, y0], np.float32)
        data["boxes"] = data["boxes"] + off
        data["points"] = data["points"] + off[:2]
        data["crop_boxes"] = np.tile(np.asarray([crop_box], np.float32), (len(data["rles"]), 1))
        return data

    def _process_batch(self, points: np.ndarray, pyramid, crop_hw: tuple, crop_box: list[int],
                       orig_size: tuple) -> dict:
        orig_h, orig_w = orig_size
        hw = tuple(int(v) for v in crop_hw)
        points_dev = torch.as_tensor(points, device=self.predictor.device)
        masks, low, iou, stab, boxes = self._decode(pyramid, points_dev, hw, self.multimask_output)
        p, m = iou.shape
        points_idx = np.repeat(np.arange(p), m)
        masks = masks.reshape(p * m, *masks.shape[2:])
        if self.use_m2m:
            # Every candidate decoded again from its own low-res mask; the
            # filters read the refined outputs.
            idx_dev = torch.as_tensor(points_idx, device=points_dev.device)
            masks, _, iou, stab, boxes = self._decode(pyramid, points_dev[idx_dev], hw, False,
                                                      low.reshape(p * m, 1, *low.shape[2:]))
            masks = masks[:, 0]
        iou = iou.reshape(-1).cpu().numpy()
        stab = stab.reshape(-1).cpu().numpy()
        boxes = boxes.reshape(-1, 4).cpu()

        keep = np.ones(p * m, bool)
        if self.pred_iou_thresh > 0.0:
            keep &= iou > self.pred_iou_thresh
        if self.stability_score_thresh > 0.0:
            keep &= stab >= self.stability_score_thresh
        keep &= ~is_box_near_crop_edge(boxes, crop_box, [0, 0, orig_w, orig_h]).numpy()
        idx = np.nonzero(keep)[0]
        kept = masks[torch.as_tensor(idx, device=masks.device)].cpu().numpy()  # only kept masks leave the card

        rles = []
        for mask in kept:
            if hw != (orig_h, orig_w):  # uncrop into the full canvas
                full = np.zeros((orig_h, orig_w), bool)
                full[crop_box[1]:crop_box[3], crop_box[0]:crop_box[2]] = mask
                mask = full
            rles.append(encode_rle(mask))
        return {
            "rles": rles,
            "iou_preds": iou[idx],
            "stability_score": stab[idx],
            "boxes": boxes.numpy()[idx].astype(np.float32),
            "points": points[points_idx[idx]],
            "points_idx": points_idx[idx],
        }

    def _postprocess_small_regions(self, data: dict, min_area: int, nms_thresh: float) -> dict:
        """Fill small holes and remove small islands on the host, then NMS
        again; a mask left unchanged wins over a changed one (score 1 vs 0)."""
        if len(data["rles"]) == 0:
            return data
        masks, scores = [], []
        for rle in data["rles"]:
            mask = decode_rle(rle)
            cleaned = remove_small_components(torch.as_tensor(mask), min_area).numpy()
            masks.append(cleaned)
            scores.append(float(np.array_equal(cleaned, mask)))
        masks = np.stack(masks)
        boxes = batched_mask_to_box(torch.as_tensor(masks)).numpy().astype(np.float32)
        keep = nms_xyxy(boxes, np.asarray(scores), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                data["rles"][i] = encode_rle(masks[i])
                data["boxes"][i] = boxes[i]
        return _filter(data, keep)


def _cat(parts: list[dict]) -> dict:
    if not parts:
        return {"rles": [], "iou_preds": np.zeros(0), "stability_score": np.zeros(0),
                "boxes": np.zeros((0, 4), np.float32), "points": np.zeros((0, 2), np.float32),
                "crop_boxes": np.zeros((0, 4), np.float32)}
    return {k: ([r for p in parts for r in p[k]] if k == "rles" else np.concatenate([p[k] for p in parts], axis=0))
            for k in parts[0]}


def _filter(data: dict, idx: np.ndarray) -> dict:
    return {k: ([v[i] for i in idx] if k == "rles" else v[idx]) for k, v in data.items()}
