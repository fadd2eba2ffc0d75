"""Per-frame 6D pose tracking on a video with the online estimator.

Frame 0 of each track runs the coarse 600-view estimator; later frames
refine within the geodesic neighbourhood of the previous pose: the
fine-view cache re-renders (kernel K1 on the card) and featurizes (DINOv2,
kernel K2 on the card) only the views entering the neighbourhood, and by
default each track runs as an AutoRefineChain, whose cache bookkeeping lives
on the device. Tracks are keyed by mesh id. Synthetic K from the image
diagonal; CSV translations in metres; real per-frame seconds in the `time`
column. The flag set is the JAX package's scripts/dino_inference_video.py
plus --device. --shard-refine fans the refine over every card (a one-shard
mesh on one card or under --device cpu) and turns the chain off.

Usage: python -m freepose_tpu_torch.scripts.dino_inference_video --video-dir FRAMES \
         --proposals scaled.json --wds-dir shards --filelist meshes.txt \
         --mesh-dir meshes --out track.csv [--weights dinov2.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.template import WebTemplateDataset
from freepose_tpu_torch.datasets.video import load_frame_dir
from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.geometry.camera import default_video_intrinsics
from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.geometry.rotation import template_poses
from freepose_tpu_torch.io.bop_csv import PoseResult, write_results_csv
from freepose_tpu_torch.io.mesh import load_obj
from freepose_tpu_torch.io.proposals_json import load_proposals, proposal_bbox_xyxy, proposal_mask
from freepose_tpu_torch.parallel.mesh import cards_mesh
from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain, OnlinePoseEstimator
from freepose_tpu_torch.pipeline.proposals import extract_proposals
from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
from freepose_tpu_torch.pipeline.template_bank import TemplateBank
from freepose_tpu_torch.scripts.common import add_device_arg, load_dino_extractor, load_filelist


def upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor; to the card from pinned memory without
    blocking the host, so the copy overlaps the work already enqueued."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def bbox_visib(bbox) -> np.ndarray:
    return np.array([bbox[0], bbox[1], bbox[2] - bbox[0], bbox[3] - bbox[1]])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-dir", required=True, help="directory of frames")
    ap.add_argument("--proposals", required=True, help="per-frame proposal JSON (with scale)")
    ap.add_argument("--wds-dir", required=True)
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--layer", type=int, default=22)
    ap.add_argument("--n-coarse", type=int, default=600)
    ap.add_argument("--n-fine", type=int, default=20000)
    ap.add_argument("--neighborhood", type=float, default=15.0)
    ap.add_argument("--n-neighbors", type=int, default=32,
                    help="static cap on the neighbourhood ball (at most 22 grid poses lie within 15 deg "
                         "of a pose of the 20k grid, 13 on the 10k grid; 16 only with --n-fine 10000)")
    ap.add_argument("--no-rescore", action="store_true", help="coarse-only per frame")
    ap.add_argument("--mask-scores", action="store_true")
    ap.add_argument("--fine-cache", type=int, default=256, metavar="SLOTS",
                    help="fine-view cache capacity (0 disables): per-view render features/masks/stats are "
                         "exact functions of the fine-grid index, so warm frames featurize only the query "
                         "crop and newly entered views")
    ap.add_argument("--zoom-renders", action="store_true",
                    help="render fine views under per-pose zoomed intrinsics (native-resolution object "
                         "detail, no crop-upsample); changes rescore numerics against the reference flow")
    ap.add_argument("--fuse-objects", action="store_true",
                    help="put all of a frame's cache-hit (resp. cache-miss) objects into one ViT batch; "
                         "same results as the serial per-object refine")
    ap.add_argument("--shard-refine", action="store_true",
                    help="fan refine work over every card: each frame's neighbour renders and feature batch "
                         "(with the fine cache, each miss batch's) split over the mesh's model axis; the cache "
                         "stays on the first card; turns --chain-refine off. One host thread launches every "
                         "shard's work, so this is slower than one card (measured on four H100s)")
    ap.add_argument("--chain-refine", type=int, default=1, metavar="0|1",
                    help="run each track as an AutoRefineChain (fine_cache.DeviceCache: the cache's slot "
                         "table, LRU and evictions on the device); results equal the serial path; needs "
                         "--fine-cache, off with --shard-refine, --fuse-objects and --no-rescore")
    ap.add_argument("--adaptive-bucket", action="store_true",
                    help="chain refine: move the stream miss bucket with the observed per-frame miss rate; "
                         "results are exact either way")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    frames = load_frame_dir(args.video_dir)
    h, w = frames.shape[1:3]
    props = load_proposals(args.proposals)
    templates = WebTemplateDataset(args.wds_dir, load_filelist(args.filelist))
    extractor = load_dino_extractor(args.weights, device=dev)
    k = default_video_intrinsics(w, h, device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=args.layer, feature_type="patch")

    renderer = TemplateRenderer(n_poses=args.n_coarse, device=dev)
    bank = TemplateBank(feature_fn, renderer, cache_size=4, device=dev)
    estimator = OnlinePoseEstimator(
        feature_fn, bank, renderer, n_coarse_poses=args.n_coarse, n_fine_poses=args.n_fine,
        n_neighbors=args.n_neighbors, extractor=extractor, feature_layer=args.layer,
        fine_cache_capacity=max(args.fine_cache, args.n_neighbors) if args.fine_cache else 0,
        shard_mesh=cards_mesh(dev, "model") if args.shard_refine else None, zoom_renders=args.zoom_renders,
    )

    by_frame: dict[int, list] = {}
    for p in props:
        by_frame.setdefault(p["image_id"], []).append(p)

    def frame_masks(f):
        """A frame's proposal masks (decoded from RLE on the host) uploaded
        to the device, and its boxes."""
        plist = by_frame.get(f, [])
        if not plist:
            return None
        masks = np.stack([proposal_mask(p) for p in plist])
        boxes = np.stack([proposal_bbox_xyxy(p).astype(np.float32) for p in plist])
        return upload(masks, dev), boxes

    # Per-object state, keyed by mesh id: single-object tracks, as after
    # filter_predictions.
    prev_pose: dict[str, torch.Tensor] = {}
    mesh_cache: dict[str, object] = {}
    packs: dict[str, object] = {}
    results: list[PoseResult] = []
    use_chain = bool(args.chain_refine and args.fine_cache and not args.shard_refine and not args.fuse_objects
                     and not args.no_rescore)
    chains: dict[str, AutoRefineChain] = {}
    chain_meta: dict[str, list] = {}
    all_scores: dict[str, list] = {}  # --no-rescore: mesh_id -> [V] per frame
    # The next frame's image and masks are uploaded while this frame runs.
    ahead = {0: (upload(frames[0], dev), frame_masks(0))} if len(frames) else {}
    for f in range(len(frames)):
        frame_f, masks_f = ahead.pop(f)
        if f + 1 < len(frames):
            ahead[f + 1] = (upload(frames[f + 1], dev), frame_masks(f + 1))
        frame_objs: list[dict] = []
        frame_meta: list[tuple] = []
        t_frame = time.perf_counter()
        plist = by_frame.get(f, [])
        if plist:
            # One crop batch for all of the frame's objects.
            masks_dev, boxes = masks_f
            frame_props = extract_proposals(frame_f, masks_dev, torch.as_tensor(boxes, device=dev),
                                            target_size=420, bbox_extend=0.2)
        for i, p in enumerate(plist):
            t0 = time.perf_counter()
            mesh_id = p["mesh"]
            if mesh_id not in mesh_cache:
                mesh_cache[mesh_id] = load_obj(Path(args.mesh_dir) / mesh_id / f"{mesh_id}.obj").normalized()
            mesh = mesh_cache[mesh_id]
            bbox = boxes[i]
            # A mesh's template views are decoded from the shards once (the
            # JAX CLI decodes them again for every proposal).
            pack = packs.get(mesh_id)
            if pack is None:
                item = templates.get_template_by_name(mesh_id)
                rgb = torch.as_tensor(item["rgb"], device=dev).permute(0, 3, 1, 2)
                tb = mask_to_bbox(torch.as_tensor(item["masks"], device=dev))
                pack = packs[mesh_id] = bank.pack_from_views(
                    item["model_name"], crop_resize_pad(rgb, tb, 420), torch.as_tensor(item["depth"], device=dev),
                    template_poses(rgb.shape[0], device=dev), torch.as_tensor(item["intrinsic"], device=dev),
                )
                del item, rgb
            scale = float(p.get("scale", 0.1))
            if args.no_rescore or mesh_id not in prev_pose:
                out = estimator.coarse.estimate(frame_props.proposals[i], pack, k, bbox, scale,
                                                return_query_feat=False, return_all_scores=args.no_rescore)
                tco = out.tcos[0].cpu().numpy()
                if args.no_rescore:
                    # Every view's coarse score, for offline analysis.
                    all_scores.setdefault(mesh_id, []).append(out.all_scores.cpu().numpy())
                else:
                    prev_pose[mesh_id] = out.tcos[0]
                results.append(PoseResult(
                    scene_id=0, im_id=f, obj_id=mesh_id, score=float(out.scores[0]), R=tco[:3, :3], t=tco[:3, 3],
                    bbox_visib=bbox_visib(bbox), scale=scale, time=time.perf_counter() - t0,
                ))
            elif use_chain:
                ch = chains.get(mesh_id)
                seed = None
                if ch is None:
                    ch = chains[mesh_id] = AutoRefineChain(
                        estimator, mesh, mesh_id, neighborhood_deg=args.neighborhood,
                        mask_scores=args.mask_scores, adaptive_bucket=args.adaptive_bucket,
                    )
                    chain_meta[mesh_id] = []
                    seed = prev_pose[mesh_id]
                ch.submit(frame_props.proposals[i], frame_props.masks[i], k, bbox, scale, prev_pose=seed)
                chain_meta[mesh_id].append((f, bbox, scale, time.perf_counter() - t0))
            else:
                frame_objs.append(dict(
                    proposal=frame_props.proposals[i], proposal_mask=frame_props.masks[i], pack=pack,
                    mesh=mesh, k=k, bbox=bbox, est_scale=scale, prev_pose=prev_pose.get(mesh_id),
                    cache_key=mesh_id,
                ))
                frame_meta.append((mesh_id, bbox, scale))
        if frame_objs:
            if args.fine_cache:
                outs = estimator.estimate_frame(frame_objs, neighborhood_deg=args.neighborhood,
                                                mask_scores=args.mask_scores, fuse=args.fuse_objects)
            else:
                outs = [
                    estimator.estimate(
                        o["proposal"], o["proposal_mask"], o["pack"], o["mesh"], o["k"], o["bbox"],
                        o["est_scale"], prev_pose=o["prev_pose"], neighborhood_deg=args.neighborhood,
                        mask_scores=args.mask_scores,
                    )
                    for o in frame_objs
                ]
            dt = (time.perf_counter() - t_frame) / len(frame_objs)
            for out, (mesh_id, bbox, scale) in zip(outs, frame_meta):
                tco = out.tcos[0].cpu().numpy()
                prev_pose[mesh_id] = out.tcos[0]
                results.append(PoseResult(
                    scene_id=0, im_id=f, obj_id=mesh_id, score=float(out.scores[0]), R=tco[:3, :3], t=tco[:3, 3],
                    bbox_visib=bbox_visib(bbox), scale=scale, time=dt,
                ))
        print(f"frame {f}: {len(plist)} objects")

    # Flush the chains (their results arrive a few frames behind).
    for mesh_id, ch in chains.items():
        for (tc, sc), (f, bbox, scale, dt) in zip(ch.finalize_all(), chain_meta[mesh_id]):
            results.append(PoseResult(
                scene_id=0, im_id=f, obj_id=mesh_id, score=sc, R=tc[:3, :3], t=tc[:3, 3],
                bbox_visib=bbox_visib(bbox), scale=scale, time=dt,
            ))

    results.sort(key=lambda r: (r.im_id, str(r.obj_id)))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    write_results_csv(results, args.out, t_scale=1.0)  # video: metres
    if args.no_rescore and all_scores:
        # Per-object per-frame view scores and the coarse pose grid, for
        # offline score-landscape analysis.
        out_dir = Path(args.out).parent
        np.save(out_dir / "all_scores.npy", np.stack([np.stack(v) for v in all_scores.values()]))
        np.save(out_dir / "all_poses.npy", estimator.coarse.mesh_poses.cpu().numpy())
        print(f"all_scores.npy + all_poses.npy -> {out_dir}")
    print(f"{len(results)} poses -> {args.out}")


if __name__ == "__main__":
    main()
