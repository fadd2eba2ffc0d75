"""Static-image proposals and CAD retrieval.

Counterpart of the JAX package's scripts/extract_proposals_ground.py, with
the same arguments (plus --device) and the same proposal JSON: per BOP
image, open-vocabulary boxes (GroundingDINO-B, prompt "objects.") -> SAM2
Hiera-L masks, all boxes of an image decoded as one prompt set (on the card
the trunk's global attention runs on kernel K2 at d 72) -> masks under
--min-mask-px dropped -> per proposal a 420² crop, DINOv2-L patch features
at --layer (kernel K2 at d 64) and FFA pooling (or the cls token) -> the
top-k of the retrieval bank -> optionally a per-view fine rerank over the
top candidates -> proposal JSON. `propose_image` is one image's work, which
the benchmark's BOP cells call too.

Detectors: grounding (GroundingDINO boxes + SAM2 masks), gt-boxes (the
ground-truth boxes + SAM2 masks), gt-masks (the ground-truth visible masks).
Without --grounding-weights / --sam2-weights / --weights the models take
seeded random weights; without a WordPiece vocabulary the prompt becomes the
placeholder ids of models/grounding_dino.py.

Usage: python -m freepose_tpu_torch.scripts.extract_proposals_ground \
         --dataset BOP_DIR --bank bank.npy --filelist meshes.txt --out-dir OUT \
         [--detector grounding|gt-boxes|gt-masks] [--grounding-weights gd.npz] \
         [--sam2-weights sam2.npz] [--weights dinov2.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.bop import BOPDataset
from freepose_tpu_torch.io.proposals_json import proposal_entry, save_proposals
from freepose_tpu_torch.ops.knn import fine_rerank_scores
from freepose_tpu_torch.pipeline.proposals import retrieve_topk
from freepose_tpu_torch.scripts.common import (
    add_device_arg,
    add_shard_args,
    get_shard,
    load_dino_extractor,
    load_filelist,
    load_grounding_detector,
    load_sam2_image_predictor,
    proposals_filename,
)


def detect(args, entry):
    """-> (boxes [N, 4] xyxy, det_scores [N], masks [N, H, W] bool or None
    where SAM2 is to segment the boxes), numpy."""
    if args.detector == "gt-masks":
        return entry["boxes"], np.ones(len(entry["boxes"])), entry["masks"]
    if args.detector == "grounding":
        boxes, det_scores = load_grounding_detector(args.grounding_weights, args.device).detect(
            entry["image"], text=args.text_prompt, box_threshold=args.box_threshold,
            text_threshold=args.text_threshold)
    elif args.detector == "gt-boxes":
        boxes, det_scores = entry["boxes"], np.ones(len(entry["boxes"]))
    else:
        raise ValueError(args.detector)
    return boxes, det_scores, None


def sam2_masks(predictor, image, boxes) -> np.ndarray:
    """SAM2's masks [N, H, W] bool of an image's boxes [N, 4] xyxy, every
    box of the image decoded as one prompt set (single-mask output)."""
    predictor.set_image(image)
    masks, _, _ = predictor.predict(box=np.asarray(boxes), multimask_output=False, fetch_low_res_logits=False)
    return masks[:, 0]


def propose_image(entry, detect_fn, segment_fn, extractor, bank_dev: torch.Tensor, names: list[str], *,
                  layer: int = 22, feature_type: str = "ffa", min_mask_px: int = 400, rerank=None,
                  telemetry: dict | None = None) -> list[dict]:
    """One BOP image's proposal entries: detection, SAM2 masks, the
    `min_mask_px` filter, DINOv2 retrieval (top-100 of the bank) and, per
    kept mask, its mesh and score.

    `entry` is a BOPDataset item (image, scene_id, frame_id; boxes and masks
    for the ground-truth detectors). `detect_fn(entry)` -> (boxes [N, 4]
    xyxy, scores [N], masks [N, H, W] bool or None); `segment_fn(image,
    boxes)` -> masks, called where the detector gave none and found a box.
    `rerank(indices [k], feature [D])` -> (mesh, score) replaces the top-1
    of the bank where given. `telemetry`, where given, receives the image's
    intermediate results (references, no copy): boxes, det_scores, masks (all
    of them), keep (indices of the kept masks), and where any was kept the
    retrieval's scores, indices and features [N_kept, ...]."""
    image = entry["image"]
    boxes, det_scores, masks = detect_fn(entry)
    if masks is None:
        masks = segment_fn(image, boxes) if len(boxes) else np.zeros((0,) + image.shape[:2], bool)
    keep = [i for i, m in enumerate(masks) if m.sum() >= min_mask_px]
    if telemetry is not None:
        telemetry.update(boxes=boxes, det_scores=det_scores, masks=masks, keep=keep)
    if not keep:
        return []
    masks, boxes = masks[keep], np.asarray(boxes)[keep]
    scores, indices, feats = retrieve_topk(
        np.array(image), masks, torch.as_tensor(boxes, dtype=torch.float32), bank_dev, extractor,
        layer=layer, feature_type=feature_type, k=min(100, len(names)), target_size=420, bbox_extend=0.1)
    if telemetry is not None:
        telemetry.update(scores=scores, indices=indices, feats=feats)
    scores, indices = scores.cpu().numpy(), indices.cpu().numpy()
    out = []
    for i in range(len(masks)):
        if rerank is not None:
            mesh, score = rerank(indices[i], feats[i])
        else:
            mesh, score = names[indices[i][0]], float(scores[i][0])
        out.append(proposal_entry(boxes[i], masks[i], mesh, score, entry["scene_id"], entry["frame_id"]))
    return out


def fine_candidates(args, names: list[str], fine_bank, rows: np.ndarray) -> np.ndarray:
    """[C, V, D] L2-normalised per-view features of the candidate meshes:
    from the consolidated bank, or one .npy per mesh."""
    if fine_bank is not None:
        return fine_bank.gather(rows)
    cand = []
    for row in rows:
        f = np.load(Path(args.fine_features_dir) / f"{names[row]}.npy")
        cand.append(f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12))
    return np.stack(cand)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--bank", required=True, help="[N, D] retrieval bank .npy")
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--detector", choices=["grounding", "gt-boxes", "gt-masks"], default="grounding")
    ap.add_argument("--text-prompt", default="objects.")
    ap.add_argument("--box-threshold", type=float, default=0.15)
    ap.add_argument("--text-threshold", type=float, default=0.15)
    ap.add_argument("--weights", default=None, help="DINOv2 params (.npz)")
    ap.add_argument("--sam2-weights", default=None)
    ap.add_argument("--grounding-weights", default=None)
    ap.add_argument("--layer", type=int, default=22)
    ap.add_argument("--feature-type", choices=["ffa", "cls"], default="ffa")
    ap.add_argument("--topk", type=int, default=0, help=">0 enables per-view fine rerank")
    ap.add_argument("--fine-features-dir", default=None, help="per-mesh [V, D] .npy dir")
    ap.add_argument("--fine-bank", default=None, help="consolidated memmap bank (io.npy_bank)")
    ap.add_argument("--min-mask-px", type=int, default=400)
    add_shard_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dataset = BOPDataset(args.dataset, args.split)
    names = load_filelist(args.filelist)
    extractor = load_dino_extractor(args.weights, device=args.device)
    bank = np.load(args.bank).astype(np.float32)
    bank /= np.maximum(np.linalg.norm(bank, axis=-1, keepdims=True), 1e-12)
    bank_dev = torch.as_tensor(bank, device=extractor.device)
    rerank = args.topk > 0 and bool(args.fine_bank or args.fine_features_dir)
    fine_bank = None
    if rerank and args.fine_bank:
        from freepose_tpu_torch.io.npy_bank import FineFeatureBank

        fine_bank = FineFeatureBank(args.fine_bank)

    def segment(image, boxes):
        return sam2_masks(load_sam2_image_predictor(args.sam2_weights, args.device), image, boxes)

    def fine_rerank(rows, feat):
        fine = torch.as_tensor(fine_candidates(args, names, fine_bank, rows), device=feat.device)
        fine_scores = fine_rerank_scores(fine, feat, args.topk).cpu().numpy()
        best = int(np.argmax(fine_scores))
        return names[rows[best]], float(fine_scores[best])

    out = []
    for idx in get_shard(args).slice(len(dataset)):
        out += propose_image(dataset[idx], lambda entry: detect(args, entry), segment, extractor, bank_dev, names,
                             layer=args.layer, feature_type=args.feature_type, min_mask_px=args.min_mask_px,
                             rerank=fine_rerank if rerank else None)

    name = proposals_filename(args.box_threshold, args.text_threshold, args.feature_type, args.layer, args.topk,
                              Path(args.dataset).name)
    path = Path(args.out_dir) / name
    save_proposals(out, path)
    print(f"{len(out)} proposals -> {path}")


if __name__ == "__main__":
    main()
