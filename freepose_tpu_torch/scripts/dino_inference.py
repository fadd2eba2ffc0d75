"""Static-image coarse 6D pose inference from proposals.

For each frame's proposals (JSON with RLE masks + retrieved mesh ids): crop,
extract DINOv2 features (attention on kernel K2 on the card), match against
the mesh's 600-view template pack built from the template shards, z-lift,
and write the BOP CSV (t in millimetres). The `time` column records real
per-proposal seconds.

Depth methods: "zoedepth" (scale carried in the proposal JSON) and
"const-*". "depthmap" needs the scale estimator (connected components,
erosion, kNN), which is not ported yet.

Usage: python -m freepose_tpu_torch.scripts.dino_inference --dataset BOP_ROOT \
         --proposals props.json --wds-dir shards --filelist meshes.txt \
         --out poses.csv [--weights dinov2.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.bop import BOPDataset
from freepose_tpu_torch.datasets.template import WebTemplateDataset
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.geometry.rotation import template_poses
from freepose_tpu_torch.io.bop_csv import PoseResult, write_results_csv
from freepose_tpu_torch.io.proposals_json import (
    filter_by_frame,
    load_proposals,
    proposal_bbox_xyxy,
    proposal_mask,
)
from freepose_tpu_torch.pipeline.pose_estimator import CoarsePoseEstimator
from freepose_tpu_torch.pipeline.proposals import extract_proposals
from freepose_tpu_torch.pipeline.template_bank import TemplateBank
from freepose_tpu_torch.scripts.common import (
    add_device_arg,
    add_shard_args,
    get_shard,
    load_dino_extractor,
    load_filelist,
)
from freepose_tpu_torch.utils.timing import StageTimer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True, help="BOP dataset root")
    ap.add_argument("--split", default="test")
    ap.add_argument("--proposals", required=True, help="proposal JSON")
    ap.add_argument("--wds-dir", required=True, help="template shards dir")
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--out", required=True, help="output CSV")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--layer", type=int, default=22)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--bbox-extend", type=float, default=0.2)
    ap.add_argument("--depth-method", default="zoedepth",
                    choices=["depthmap", "zoedepth", "const-0.05", "const-0.1"])
    ap.add_argument("--scenes-per-task", type=int, default=30)
    ap.add_argument("--cache-dir", default=None)
    add_shard_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.depth_method == "depthmap":
        raise NotImplementedError(
            "--depth-method depthmap needs pipeline/scale_estimator.depth_scales, which is "
            "not ported yet (ROADMAP queue 1, item 7); use zoedepth or const-*"
        )

    dataset = BOPDataset(args.dataset, args.split)
    props = load_proposals(args.proposals)
    templates = WebTemplateDataset(args.wds_dir, load_filelist(args.filelist))
    extractor = load_dino_extractor(args.weights, device=args.device)
    dev = extractor.device

    def feature_fn(imgs):
        return extractor(imgs, layer=args.layer, feature_type="patch")

    bank = TemplateBank(feature_fn, cache_size=8, cache_dir=args.cache_dir,
                        batch_size=args.batch_size, device=dev)
    estimator = CoarsePoseEstimator(feature_fn, bank)
    timer = StageTimer()

    shard = get_shard(args)
    frame_indices = shard.slice(len(dataset), chunk=None if shard.count == 1 else args.scenes_per_task)

    results: list[PoseResult] = []
    for idx in frame_indices:
        entry = dataset[idx]
        scene_props = filter_by_frame(props, entry["scene_id"], entry["frame_id"])
        if not scene_props:
            continue
        masks = np.stack([proposal_mask(p) for p in scene_props])
        boxes = np.stack([proposal_bbox_xyxy(p) for p in scene_props]).astype(np.float32)
        mesh_ids = [p["mesh"] for p in scene_props]

        with timer.stage("proposals"):
            prop = extract_proposals(
                torch.tensor(entry["image"], device=dev), torch.as_tensor(masks, device=dev),
                torch.as_tensor(boxes, device=dev), target_size=420, bbox_extend=args.bbox_extend,
            )

        if args.depth_method.startswith("const-"):
            scales = np.full(len(scene_props), float(args.depth_method.split("-")[1]))
        else:  # zoedepth: scale carried in the proposal JSON (compute_scale)
            scales = np.asarray([max(p.get("scale", 0.1), 0.01) for p in scene_props])

        t0 = time.perf_counter()
        packs = []
        with timer.stage("templates"):
            for mesh_id in mesh_ids:
                item = templates.get_template_by_name(mesh_id)
                pack = bank.cache.get(item["model_name"])
                if pack is None:
                    rgb = torch.as_tensor(item["rgb"], device=dev).permute(0, 3, 1, 2)
                    tmpl_boxes = mask_to_bbox(torch.as_tensor(item["masks"], device=dev))
                    crops = crop_resize_pad(rgb, tmpl_boxes, 420)
                    pack = bank.pack_from_views(
                        item["model_name"],
                        crops,
                        torch.as_tensor(item["depth"], device=dev),
                        template_poses(rgb.shape[0], device=dev),
                        torch.as_tensor(item["intrinsic"], device=dev),
                    )
                    bank.cache[item["model_name"]] = pack
                packs.append(pack)
        with timer.stage("pose"):
            # One ViT batch for every proposal of the frame, then per-pack scoring.
            outs = estimator.estimate_batch(
                prop.proposals, packs, torch.as_tensor(entry["intrinsic"], dtype=torch.float32),
                boxes, scales,
            )
        dt = (time.perf_counter() - t0) / max(len(mesh_ids), 1)
        for i, (mesh_id, out) in enumerate(zip(mesh_ids, outs)):
            tco = out.tcos[0].cpu().numpy()
            results.append(PoseResult(
                scene_id=entry["scene_id"], im_id=entry["frame_id"], obj_id=mesh_id,
                score=float(out.scores[0]), R=tco[:3, :3], t=tco[:3, 3],
                bbox_visib=np.array([boxes[i][0], boxes[i][1],
                                     boxes[i][2] - boxes[i][0], boxes[i][3] - boxes[i][1]]),
                scale=float(scales[i]), time=dt,
            ))

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    write_results_csv(results, args.out, t_scale=1000.0)  # BOP static: mm
    print(f"{len(results)} poses -> {args.out}")
    print(timer.report())


if __name__ == "__main__":
    main()
