"""SAM2 predictors: image (set_image / predict) and video (init, prompt,
propagate).

Counterpart of freepose_tpu.models.sam2.predictor's Sam2ImagePredictor and
Sam2VideoPredictor: the same calls and the same outputs. The image predictor
embeds an image once and decodes every prompt set against the cached
pyramid; all boxes of an image decode as one batched prompt set. The JAX
predictor bit-packs binary masks on the device to cut the host transfer;
here bool masks come back directly (the same masks). For video, objects are
grouped by (prompt frame, prompt kind); each group's state is stepped once
per frame with all its objects batched. The JAX predictor scans 8-frame
chunks in one program and prefetches uploads to pipeline TPU dispatch; on
CUDA frames run one by one, and `chunk` is accepted and changes nothing in
the output.
"""
from __future__ import annotations

import numpy as np
import torch

from freepose_tpu_torch.models.sam2.model import Sam2Config, Sam2ImageModel, sam2_normalize
from freepose_tpu_torch.models.sam2.video import Sam2VideoConfig, Sam2VideoModel, init_object_state
from freepose_tpu_torch.ops.sampling import resize_bilinear


def prepare_image(image: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, 3] uint8 or float -> [1, 3, size, size] normalised."""
    img = image.float()
    if image.dtype == torch.uint8:
        img = img / 255.0
    return sam2_normalize(resize_bilinear(img.permute(2, 0, 1), (size, size))[None])


def apply_non_overlapping_constraints(pred_masks: torch.Tensor) -> torch.Tensor:
    """Keep only the highest-scoring object per pixel; the others clamp to
    <= -10. Objects on the leading axis."""
    if pred_masks.shape[0] == 1:
        return pred_masks
    ids = torch.arange(pred_masks.shape[0], device=pred_masks.device).reshape(-1, *([1] * (pred_masks.ndim - 1)))
    keep = pred_masks.argmax(dim=0, keepdim=True) == ids
    return torch.where(keep, pred_masks, torch.clamp(pred_masks, max=-10.0))


def postprocess_video_masks(low: torch.Tensor, high: torch.Tensor, orig_hw: tuple[int, int], non_overlap: bool,
                            binarize: bool):
    """Resize high-res logits [N, S, S] to the original resolution, apply the
    optional cross-object suppression, and optionally threshold at 0."""
    high = resize_bilinear(high, orig_hw)
    if non_overlap and low.shape[0] > 1:
        low = apply_non_overlapping_constraints(low)
        high = apply_non_overlapping_constraints(high)
    if binarize:
        return low > 0, high > 0
    return low.float(), high


def scale_coords(coords: torch.Tensor, orig_hw: tuple[int, int], size: int) -> torch.Tensor:
    """Pixel coordinates (x, y) in the original image -> model input coordinates."""
    h, w = orig_hw
    return coords * torch.tensor([size / w, size / h], dtype=coords.dtype, device=coords.device)


class Sam2ImagePredictor:
    """Prompted masks on one image. params: the JAX package's Sam2ImageModel
    parameter tree (the "image" subtree of a video model's), converted by
    models/convert.py:state_dict_from_jax; None gives seeded random weights.
    Runs on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: Sam2Config, params=None, image_size: int = 1024, device=None, seed: int = 0):
        from freepose_tpu_torch.device import resolve_device
        from freepose_tpu_torch.models.convert import random_sam2_image_params, state_dict_from_jax

        self.config = config
        self.device = resolve_device(device)
        self.image_size = image_size
        if params is None:
            params = random_sam2_image_params(config, seed=seed)
        model = Sam2ImageModel(config)
        missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=False)
        # A tree from the JAX model's own init lacks the mask-prompt encoder,
        # which no image prompt here reaches.
        if unexpected or any(not k.startswith("prompt_encoder.mask_embed.") for k in missing):
            raise ValueError(f"SAM2 image parameters do not fit: missing {missing}, unexpected {unexpected}")
        self.model = model.to(self.device).eval()
        self._pyramid = None
        self._orig_hw = None

    @torch.inference_mode()
    def set_image(self, image) -> None:
        """image [H, W, 3] uint8 or float in [0, 1] (numpy or a tensor)."""
        image = torch.as_tensor(image if torch.is_tensor(image) else np.array(image), device=self.device)
        self._orig_hw = (int(image.shape[0]), int(image.shape[1]))
        self._pyramid, _ = self.model.embed_image(prepare_image(image, self.image_size))

    def _scale_prompts(self, point_coords, point_labels, box):
        """Prompts in original pixels -> (points [1, P, N, 2], labels
        [1, P, N], boxes [1, P, 4]) in model coordinates, or None each."""
        pts = labels = boxes = None
        dev, hw, size = self.device, self._orig_hw, self.image_size
        if point_coords is not None:
            pts = scale_coords(torch.as_tensor(np.asarray(point_coords), dtype=torch.float32, device=dev), hw, size)
            pts = pts.reshape(1, -1, pts.shape[-2] if pts.ndim > 2 else pts.shape[0], 2)
            labels = torch.as_tensor(np.asarray(point_labels), device=dev).long().reshape(1, pts.shape[1], -1)
        if box is not None:
            b = torch.as_tensor(box if torch.is_tensor(box) else np.asarray(box), dtype=torch.float32, device=dev)
            boxes = scale_coords(b.reshape(1, -1, 2, 2), hw, size).reshape(1, -1, 4)
        return pts, labels, boxes

    @torch.inference_mode()
    def _decode(self, point_coords, point_labels, box, multimask_output: bool):
        if self._pyramid is None:
            raise RuntimeError("call set_image first")
        pts, labels, boxes = self._scale_prompts(point_coords, point_labels, box)
        masks, iou, _, _ = self.model.decode_masks(self._pyramid, points=pts, labels=labels, boxes=boxes,
                                                   multimask_output=multimask_output)
        return masks[0], iou[0]

    def predict(self, point_coords=None, point_labels=None, box=None, multimask_output: bool = True,
                return_logits: bool = False, fetch_low_res_logits: bool = True):
        """Returns (masks [P, M, H, W] at the original resolution, iou
        [P, M], low-res logits [P, M, g, g]) as numpy arrays: bool masks
        (logits > 0), or float logits with return_logits; the low-res logits
        are None when fetch_low_res_logits is False."""
        logits, iou = self._decode(point_coords, point_labels, box, multimask_output)
        full = resize_bilinear(logits, self._orig_hw)
        full = full if return_logits else full > 0
        low = logits.float().cpu().numpy() if fetch_low_res_logits else None
        return full.cpu().numpy(), iou.float().cpu().numpy(), low

    def predict_device(self, point_coords=None, point_labels=None, box=None, multimask_output: bool = True):
        """`predict` with device outputs: (bool masks [P, M, H, W] at the
        original resolution, iou [P, M]); box prompts may be device tensors
        (GroundingDinoDetector.detect_topk_device's boxes)."""
        logits, iou = self._decode(point_coords, point_labels, box, multimask_output)
        return resize_bilinear(logits, self._orig_hw) > 0, iou


class Sam2VideoPredictor:
    """Multi-object video tracker. params: the JAX package's parameter tree
    (nested dicts of numpy arrays), converted by
    models/convert.py:sam2_video_from_jax; None gives seeded random
    weights. Runs on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: Sam2VideoConfig, params=None, max_objects: int = 8, device=None, seed: int = 0):
        from freepose_tpu_torch.device import resolve_device
        from freepose_tpu_torch.models.convert import random_sam2_video_params, sam2_video_from_jax

        self.config = config
        self.device = resolve_device(device)
        self.max_objects = max_objects
        if params is None:
            params = random_sam2_video_params(config, seed=seed)
        model = Sam2VideoModel(config)
        model.load_state_dict(sam2_video_from_jax(params))
        self.model = model.to(self.device).eval()

    def init_state(self, frames):
        """frames: [T, H, W, 3] uint8 or float array (host memory)."""
        t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        return {"frames": frames, "orig_hw": (h, w), "num_frames": t, "n_objects": 0, "obj_ids": [],
                "prompts": {}, "pyramid_cache": {}}

    @torch.inference_mode()
    def _frame_pyramid(self, state, frame_idx: int):
        cache = state["pyramid_cache"]
        if frame_idx not in cache:
            cache.clear()  # a one-frame cache, as the reference keeps
            frame = torch.as_tensor(np.asarray(state["frames"][frame_idx]), device=self.device)
            cache[frame_idx] = self.model.embed_frame(prepare_image(frame, self.config.image_size))
        return cache[frame_idx]

    def _register(self, state, obj_id: int, prompt) -> None:
        # Re-prompting an existing object replaces its prompt: the next
        # propagation rebuilds every object's state from its prompt.
        if obj_id in state["obj_ids"]:
            idx = state["obj_ids"].index(obj_id)
        else:
            state["obj_ids"].append(obj_id)
            idx = len(state["obj_ids"]) - 1
        state["prompts"][idx] = prompt
        state["n_objects"] = len(state["obj_ids"])

    def add_new_points_or_box(self, state, frame_idx: int, obj_id: int, points=None, labels=None, box=None):
        """Register an object with its prompt; tracking starts at this
        frame. A box becomes 2 corner points labelled (2, 3)."""
        h, w = state["orig_hw"]
        size = self.config.image_size
        if box is not None:
            pts = np.asarray(box, np.float64).reshape(2, 2) * np.array([size / w, size / h])
            lbl = np.array([2, 3], np.int32)
        else:
            pts = np.asarray(points, np.float64).reshape(-1, 2) * np.array([size / w, size / h])
            lbl = np.asarray(labels, np.int32).reshape(-1)
        pad = self.config.max_point_prompts - pts.shape[0]
        pts = np.pad(pts, ((0, pad), (0, 0)))
        lbl = np.pad(lbl, (0, pad), constant_values=-10)  # -10 = padding points
        self._register(state, obj_id, (frame_idx, pts.astype(np.float32), lbl))
        return state

    def add_new_mask(self, state, frame_idx: int, obj_id: int, mask: np.ndarray):
        """Register an object with a binary mask prompt: the mask is resized
        to the model resolution (bilinear, then >= 0.5) and conditions the
        object's init step as its output."""
        mask = np.asarray(mask)
        self._register(state, obj_id, (frame_idx, None, None, mask if mask.dtype == bool else mask > 0))
        return state

    @torch.inference_mode()
    def propagate_in_video(self, state, start_frame_idx: int = 0, max_frames: int | None = None,
                           reverse: bool = False, non_overlap_masks: bool = False, binarize: bool = False,
                           chunk: int = 8):
        """Generator over frames -> (frame_idx, obj_ids, low-res masks
        [N, g4, g4], high-res masks [N, H, W] at the original resolution),
        as numpy arrays; bool masks (> 0) when binarize. reverse=True runs
        from the earliest prompt frame towards frame 0."""
        n = state["n_objects"]
        if n == 0:
            raise ValueError("no objects added")
        cfg = self.config
        dev = self.device
        num_frames = state["num_frames"]
        end = num_frames if max_frames is None else min(num_frames, start_frame_idx + max_frames)

        groups: dict[tuple[int, str], list[int]] = {}
        for i in range(n):
            p = state["prompts"][i]
            kind = "mask" if len(p) > 3 and p[3] is not None else "pts"
            groups.setdefault((p[0], kind), []).append(i)
        prompt_frame = min(k[0] for k in groups)

        def init_group(key, idxs, pyramid, pos, t):
            st = init_object_state(cfg, len(idxs), device=dev)
            if key[1] == "mask":
                ms = torch.as_tensor(np.stack([np.asarray(state["prompts"][i][3], np.float32) for i in idxs]),
                                     device=dev)
                mk = (resize_bilinear(ms, (cfg.image_size, cfg.image_size)) >= 0.5).float()
                return self.model.track_step(st, pyramid, pyramid[2], pos[2], t, num_frames, mask_inputs=mk,
                                             is_init=True)
            pts = torch.as_tensor(np.stack([state["prompts"][i][1] for i in idxs]), device=dev)[:, None]
            lbl = torch.as_tensor(np.stack([state["prompts"][i][2] for i in idxs]), device=dev).long()[:, None]
            return self.model.track_step(st, pyramid, pyramid[2], pos[2], t, num_frames, points=pts, labels=lbl,
                                         is_init=True)

        live: dict = {}
        if reverse:
            lo = -1 if max_frames is None else max(prompt_frame - max_frames, -1)
            order = range(prompt_frame, lo, -1)
            # Groups prompted after the sweep's start condition at their own
            # prompt frame first, so every object is tracked on every frame.
            for key in sorted(groups):
                if key[0] != prompt_frame:
                    pyramid_pf, pos_pf = self._frame_pyramid(state, key[0])
                    live[key], _ = init_group(key, groups[key], pyramid_pf, pos_pf, key[0])
        else:
            order = range(prompt_frame, end)

        for t in order:
            pyramid, pos = self._frame_pyramid(state, t)
            outs = []
            for key in sorted(groups):
                if key[0] == t and key not in live:
                    live[key], out = init_group(key, groups[key], pyramid, pos, t)
                    outs.append((groups[key], out))
            for key in sorted(live):
                if key[0] == t:
                    continue  # just initialised on this frame
                live[key], out = self.model.track_step(live[key], pyramid, pyramid[2], pos[2], t, num_frames,
                                                       reverse=reverse)
                outs.append((groups[key], out))
            l0, h0 = outs[0][1]["pred_masks"], outs[0][1]["high_res_masks"]
            low_raw = torch.full((n,) + l0.shape[1:], -32.0, dtype=l0.dtype, device=dev)
            high_raw = torch.full((n,) + h0.shape[1:], -32.0, dtype=h0.dtype, device=dev)
            for idxs, out in outs:  # objects whose prompt frame has not come keep no-object logits
                ii = torch.as_tensor(idxs, device=dev)
                low_raw[ii] = out["pred_masks"]
                high_raw[ii] = out["high_res_masks"]
            low, high = postprocess_video_masks(low_raw, high_raw, state["orig_hw"], non_overlap_masks, binarize)
            yield t, list(state["obj_ids"]), low.cpu().numpy(), high.cpu().numpy()
