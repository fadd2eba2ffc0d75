"""SAM2 tracking of one box-prompted object, frame at a time, on the frozen
float32 video model: the prompt frame's init step, then a memory-conditioned
step on every later frame.

The reference follows the program's discrete choices as a served model's
reference follows its served tokens: where SAM2 picks one of its candidate
masks (the best predicted IoU, on every frame after the prompt), `track`
takes the candidate whose logits the program's own low-res mask of that
frame contradicts least (the smallest largest |logit| among the pixels it
decides otherwise; then the larger IoU), so its memory holds what the
program's did, and records its own predicted IoUs to judge the choice by.
A rule by IoU alone can take a near-twin of the program's candidate, whose
few pixels of confident difference weigh no more than rounding's."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.frozen.sam2.model import sam2_normalize
from benchmark.reference.frozen.sam2.video import init_object_state
from benchmark.reference.frozen.sampling import resize_bilinear


def prepare(frame: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, 3] uint8 -> [1, 3, size, size] normalised."""
    img = frame.float() / 255.0
    return sam2_normalize(resize_bilinear(img.permute(2, 0, 1), (size, size))[None])


def box_prompt(box: np.ndarray, hw: tuple[int, int], size: int, cap: int, device):
    """A box as SAM2's two corner points (labels 2, 3), padded to `cap`
    points with label -10 -> (points [1, 1, cap, 2], labels [1, 1, cap])."""
    h, w = hw
    pts = np.zeros((cap, 2), np.float32)
    pts[:2] = np.asarray(box, np.float64).reshape(2, 2) * np.array([size / w, size / h])
    lbl = np.full((cap,), -10, np.int64)
    lbl[:2] = (2, 3)
    return torch.as_tensor(pts, device=device)[None, None], torch.as_tensor(lbl, device=device)[None, None]


def upsample(low: torch.Tensor, size: int, hw: tuple[int, int]) -> torch.Tensor:
    """Low-res logits [..., g, g] -> at the frame's size [..., H, W], as the
    model and the predictor resize them."""
    return resize_bilinear(resize_bilinear(low.float(), (size, size)), hw)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of a [g, g] with each of b [M, g, g] (1 where both are empty)."""
    inter = (a[None] & b).sum(dim=(-2, -1)).float()
    union = (a[None] | b).sum(dim=(-2, -1)).float()
    return torch.where(union > 0, inter / union.clamp(min=1), torch.ones_like(union))


def own_choice(rec: dict) -> int:
    """The candidate a frame's own rule takes: the best predicted IoU, or
    on the prompt frame the single mask where it is stable (else the best
    of the others)."""
    if rec["stability"] is None:
        return int(torch.argmax(rec["iou"]))
    return 0 if rec["stability"] >= rec["thresh"] else 1 + int(torch.argmax(rec["iou"][1:]))


def choice_gap(rec: dict, j: int) -> float:
    """How near a frame's own rule came to taking candidate j: the amount by
    which j's predicted IoU lies below the best; on the prompt frame also
    the distance of the single mask's stability from the threshold, on the
    side that takes the single mask (j = 0) or the others (j > 0)."""
    if rec["stability"] is None:
        return float(rec["iou"].max() - rec["iou"][j])
    margin = rec["stability"] - rec["thresh"]
    if j == 0:
        return max(0.0, -margin)
    others = rec["iou"][1:]
    return max(0.0, margin, float(others.max() - others[j - 1]))


def nearest_candidate(mask: torch.Tensor, logits: torch.Tensor) -> int:
    """The candidate [M, g, g] of logits that the bool mask [g, g]
    contradicts least: the smallest largest |logit| among the pixels whose
    sign the mask decides otherwise, ties to the larger IoU."""
    wrong = mask[None] != (logits > 0)
    gap = torch.where(wrong, logits.abs().float(), torch.zeros((), device=logits.device)).amax(dim=(-2, -1))
    iou = _iou(mask, logits > 0)
    return min(range(logits.shape[0]), key=lambda m: (float(gap[m]), -float(iou[m])))


@torch.inference_mode()
def track(model, frames: np.ndarray, box: np.ndarray, n_frames: int, upto: int, device, follow: dict,
          keep: set):
    """Frames 0..upto of a video of `n_frames` frames, the object
    box-prompted on frame 0; `follow` maps each frame after the prompt to
    the program's low-res mask [g, g] bool, whose nearest candidate
    (nearest_candidate) the step takes; on the prompt frame the candidates
    are every mask token's output, the single mask first, among which the
    decoder's stability fallback chooses. Yields (t, record):
    record["iou"] the model's predicted IoU of each candidate [M],
    record["stability"] the single mask's stability on the prompt frame
    (else None) and record["thresh"] its threshold, record["chosen"] the
    candidate taken, and for t in `keep` record["candidates"], every
    candidate's logits at the frame's size [M, H, W]."""
    cfg = model.config
    hw = frames.shape[1:3]
    state = init_object_state(cfg, 1, device=device)
    points, labels = box_prompt(box, hw, cfg.image_size, cfg.max_point_prompts, device)
    decoder = model.image.decoder
    for t in range(upto + 1):
        rec = {"stability": None, "thresh": decoder.cfg.stability_thresh}

        def choose(masks, iou, _t=t, _rec=rec):
            j = nearest_candidate(follow[_t].to(masks.device), masks[0])
            _rec.update(iou=iou[0].float(), chosen=j)
            if _t == 0:
                _rec["stability"] = float(decoder._stability(masks[0, 0].float()))
            if _t in keep:
                _rec["candidates"] = upsample(masks[0], cfg.image_size, hw)
            return torch.tensor([j], device=masks.device)

        pyramid, pos = model.embed_frame(prepare(torch.as_tensor(frames[t], device=device), cfg.image_size))
        if t == 0:
            state, _ = model.track_step(state, pyramid, pyramid[2], pos[2], 0, n_frames, points=points,
                                        labels=labels, is_init=True, choose=choose)
        else:
            state, _ = model.track_step(state, pyramid, pyramid[2], pos[2], t, n_frames, choose=choose)
        yield t, rec
