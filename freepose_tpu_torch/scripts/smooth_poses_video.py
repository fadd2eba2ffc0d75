"""Track-and-refine a coarse video pose track: point tracking, EPnP and SE(3)
smoothing.

Every frame's coarse pose is scored by render-and-compare inliers (DINOv2-B
at 518²: kernel K2 on the card; the renders at 518², tile 37: kernel K1);
from the best frame, intervals of --interval frames are walked outward; in
each, 2D-3D correspondences are generated at the start pose, tracked over
the interval (CoTracker2 with --tracker-weights, else the weight-free ZNCC
chain) and solved per frame with EPnP on the host CPU. The coarse
translations are kept and the track is smoothed -> `{video}-tracked.csv`.
The flag set is the JAX package's scripts/smooth_poses_video.py plus
--device.

Two behaviours differ from the JAX script on purpose: --cap-buckets adapts
the cap only for the ZNCC tracker, whose points are tracked independently
(CoTracker2's attention couples them, so a smaller query set changes every
track), and the buckets are those at most --cap plus --cap itself (the JAX
script clamps a --cap above 512 to 512).

Usage: python -m freepose_tpu_torch.scripts.smooth_poses_video --video-dir FRAMES \
         --poses coarse.csv --mesh-dir meshes [--tracker-weights cotracker2.npz] \
         [--weights dinov2_vitb.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.video import load_frame_dir, stage_frames
from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.geometry.camera import default_video_intrinsics
from freepose_tpu_torch.geometry.se3 import smooth_transforms
from freepose_tpu_torch.io.bop_csv import PoseResult, read_results_csv, write_results_csv
from freepose_tpu_torch.io.mesh import load_obj
from freepose_tpu_torch.models.cotracker import PointTracker
from freepose_tpu_torch.parallel.mesh import pad_to_multiple
from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner
from freepose_tpu_torch.scripts.common import add_device_arg, full_fp32, load_dino_extractor
from freepose_tpu_torch.utils import timing

# The keys of each interval's record in smooth_track's `telemetry["intervals"]`.
INTERVAL_RECORD = ("start", "frames", "queries", "surface", "valid", "tracks", "visibility", "poses")


def predict_interval(refiner, mesh, frames, k, start_pose, start_idx, indices):
    """Track the correspondences of `start_idx` across `indices` (host
    frames) and solve EPnP for each frame -> {frame: [4, 4]}."""
    photo0 = frames[start_idx].transpose(2, 0, 1) / 255.0
    query, surface, valid = refiner.compute_2d3d_correspondences(mesh, photo0, k, start_pose)
    if valid.sum() < 4:
        return {i: start_pose for i in indices}
    sub = frames[[min(max(i, 0), len(frames) - 1) for i in indices]].astype(np.float32) / 255.0
    tracks, vis = refiner.track_frames(sub, query[valid], query_frame=indices.index(start_idx))
    poses = refiner.compute_pnp_batch(tracks, surface[valid], vis, k)
    return {frame_idx: poses[li] for li, frame_idx in enumerate(indices)}


def cap_set(cap: int, cap_buckets) -> tuple:
    """The adaptive caps: the buckets at most `cap`, and `cap` itself as the
    largest."""
    return tuple(sorted({int(b) for b in cap_buckets if int(b) <= cap} | {int(cap)}))


def _batched_intervals(refiner, mesh, frames_dev, k, poses, starts, step, n, cap, refined: dict,
                       device_mesh=None, mesh_axis: str = "data") -> None:
    """Every interval at once: one correspondence render of all starts, the
    top-`cap` selection per start, one batch of ZNCC chains, one set of reads
    and host EPnP per interval. The start batch pads to a bucket derived from
    the staged frame count (`frames_dev.shape[0] // step + 2`, rounded up to
    lcm(4, devices on `mesh_axis`)), with repeats of the last start whose
    rows are dropped. With `device_mesh` the starts' renders and chains split
    over `mesh_axis`, each shard on its device. Numerics are the pipelined
    path's: the same selection order, chain and masked EPnP per interval."""
    n_dev = device_mesh.shape[mesh_axis] if device_mesh is not None else 1
    i_bucket = pad_to_multiple(int(frames_dev.shape[0]) // step + 2, 4, n_dev)
    if len(starts) > i_bucket:
        raise ValueError(f"{len(starts)} interval starts > bucket {i_bucket}")
    starts_pad = list(starts) + [starts[-1]] * (i_bucket - len(starts))
    query_b, surface_b, valid_b = refiner.correspondences_batch(mesh, k, np.stack([poses[s] for s in starts_pad]),
                                                                device_mesh=device_mesh, axis=mesh_axis)
    g2 = valid_b.shape[1]
    order_b = torch.argsort(torch.where(valid_b, 0, g2 + 1) + torch.arange(g2, device=valid_b.device)[None],
                            dim=1)[:, :min(cap, g2)]
    qs_b = torch.take_along_dim(query_b, order_b[..., None], dim=1)
    ss_b = torch.take_along_dim(surface_b, order_b[..., None], dim=1)
    vs_b = torch.take_along_dim(valid_b, order_b, dim=1)
    idx_rows = []
    for s in starts_pad:
        idxs = list(range(s, min(s + step, n)))
        idx_rows.append([min(max(i, 0), n - 1) for i in idxs] + [idxs[-1]] * (step - len(idxs)))
    subs = frames_dev[torch.as_tensor(idx_rows, device=frames_dev.device)]
    tracks_b, scores_b = refiner.tracker.track_device_batch(subs, qs_b, device_mesh=device_mesh, axis=mesh_axis)
    tracks_np, scores_np, vs_np_b, ss_np_b = (x.cpu().numpy() for x in (tracks_b, scores_b, vs_b, ss_b))
    for ii, s in enumerate(starts):
        idxs = list(range(s, min(s + step, n)))
        if vs_np_b[ii].sum() < 4:
            for i in idxs:
                refined[i] = poses[s]
            continue
        pv = refiner.compute_pnp_batch(tracks_np[ii], ss_np_b[ii], (scores_np[ii] > 0.5) & vs_np_b[ii][None], k)
        for li, fi in enumerate(idxs):
            refined[fi] = pv[li]


def smooth_track(refiner, mesh, frames, k, poses, interval: int = 12, pipelined: bool = True, cap: int = 512,
                 keep_coarse_translation: bool = True, inliers=None, device_mesh=None, mesh_axis: str = "data",
                 batched_intervals: bool | None = None, cap_buckets=None, telemetry=None):
    """The track-refine pass over one video -> (smoothed [N, 4, 4], inliers
    [N]).

    `frames` is the host [T, H, W, 3] uint8 video, or (pipelined only) the
    video staged on the device: one uint8 tensor (datasets/video.py:
    stage_frames) or a StagedVideo at a frame bucket (stage_frames_hbm).
    Confidence chunks and interval frames are then sliced there.

    `inliers` [N], when given, are the confidence scoring's counts (e.g. a
    StreamingInliers pass that ran behind the refine loop): the pass starts
    from them instead of scoring again.

    pipelined=True: each interval tracks the first `cap` valid
    correspondences in grid order, with padded rows masked out of EPnP, and
    every interval's correspondences and tracks are enqueued before any
    result is read. pipelined=False tracks each interval's valid subset,
    anchored on the refined pose of its start where there is one (the JAX
    script's exact path).

    batched_intervals=True (a staged video and a ZNCC tracker) runs every
    interval in one batch (`_batched_intervals`), with the pipelined path's
    results; None takes it only with a device mesh, as in the JAX package.

    `device_mesh` (parallel/mesh.py; a staged video) splits the pass over
    its `mesh_axis`: each confidence chunk's frames, and the batched
    intervals' starts and chains, one block per shard.

    `cap_buckets` (pipelined, ZNCC only) sizes each interval's cap to the
    smallest of `cap_set(cap, cap_buckets)` that holds its valid count: the
    same result as the static cap, since ZNCC tracks each point on its own.
    For CoTracker2 the cap stays static. `telemetry` (a dict) records the
    caps chosen under "cap_choices", the confidence threshold the pass
    scored its inliers at under "inliers_threshold", and (pipelined) each
    interval under "intervals", in the order tracked: a dict of
    INTERVAL_RECORD's keys holding its start frame, its frames, the query
    points, surface points and valid flags it tracked (device tensors, as
    the tracker got them), the tracker's tracks and visibility [step, N]
    (padded to `step` frames; the ZNCC chain's scores, which EPnP takes
    above 0.5) and the EPnP poses [step, 4, 4] before
    smoothing (None where fewer than 4 points are valid). The record holds
    references only: it adds no copy and no synchronisation.

    Tracing (utils/timing.py): spans `smooth.inliers`, and per interval
    `smooth.correspondences`, `smooth.track` and `smooth.pnp`, then
    `smooth.transforms`; counters `smooth.frames` (the video's) and
    `smooth.intervals`."""
    from freepose_tpu_torch.datasets.video import StagedVideo

    if isinstance(frames, StagedVideo):
        frames_dev, n = frames.frames, frames.n
    elif torch.is_tensor(frames):
        frames_dev, n = frames, len(frames)
    else:
        frames_dev, n = None, len(frames)
    staged = frames_dev is not None
    if device_mesh is not None and not staged:
        raise ValueError("device_mesh requires a device-staged video")
    if staged and not pipelined:
        raise ValueError("a device-staged video takes the pipelined path")
    if inliers is not None:
        inliers = np.asarray(inliers)
        if len(inliers) != n:
            raise ValueError(f"inliers length {len(inliers)} != {n} frames")
    else:
        with timing.span("smooth.inliers"):
            if staged:
                inliers, thr = refiner.n_inliers_per_pose(mesh, frames_dev[:n], k, poses, channels_last=True,
                                                          device_mesh=device_mesh, mesh_axis=mesh_axis)
            else:
                inliers, thr = refiner.n_inliers_per_pose(mesh, frames.transpose(0, 3, 1, 2), k, poses)
        if telemetry is not None:
            telemetry["inliers_threshold"] = thr
    timing.count("smooth.frames", n)
    best = int(np.argmax(inliers))
    step = interval
    refined: dict[int, np.ndarray] = {}
    starts = [s for s in sorted(set(range(best, n, step)) | set(range(best, -1, -step))) if s < n]
    if batched_intervals is None:
        batched_intervals = device_mesh is not None
    if batched_intervals and not staged:
        raise ValueError("batched_intervals requires a device-staged video")
    if batched_intervals and getattr(refiner.tracker, "track_device_batch", None) is None:
        raise ValueError("batched_intervals requires a batch-capable tracker (ZNCC)")
    if batched_intervals:
        _batched_intervals(refiner, mesh, frames_dev, k, poses, starts, step, n, cap, refined, device_mesh,
                           mesh_axis)
    elif not pipelined:
        for s in starts:
            idxs = list(range(s, min(s + step, n)))
            if idxs:
                refined.update(predict_interval(refiner, mesh, frames, k, refined.get(s, poses[s]), s, idxs))
    else:
        track_dev = getattr(refiner.tracker, "track_device", None)
        caps = cap_set(cap, cap_buckets) if cap_buckets is not None and track_dev is not None else None
        pre = []
        for s in starts:
            idxs = list(range(s, min(s + step, n)))
            if not idxs:
                continue
            photo = np.zeros((3, 2, 2), np.float32)  # never read
            with timing.span("smooth.correspondences"):
                query, surface, valid = refiner.compute_2d3d_correspondences(mesh, photo, k, poses[s], fetch=False)
            pre.append((s, idxs, query, surface, valid, valid.sum() if caps is not None else None))
        jobs = []
        for s, idxs, query, surface, valid, nv in pre:
            timing.count("smooth.intervals")
            icap = cap
            if nv is not None:
                icap = next((b for b in caps if b >= int(nv)), caps[-1])
                if telemetry is not None:
                    telemetry.setdefault("cap_choices", []).append((s, icap))
            # Valid correspondences first, in grid order, then padding.
            g2 = valid.shape[0]
            order = torch.argsort(torch.where(valid, 0, g2 + 1) + torch.arange(g2, device=valid.device))[:min(icap, g2)]
            qs, ss, vs = query[order], surface[order], valid[order]
            # Every interval padded to `step` frames (repeats of its last).
            pad_idxs = [min(max(i, 0), n - 1) for i in idxs] + [idxs[-1]] * (step - len(idxs))
            with timing.span("smooth.track"):
                sub = frames_dev[torch.as_tensor(pad_idxs, device=frames_dev.device)] if staged else frames[pad_idxs]
                if track_dev is not None:
                    tracks, scores = track_dev(sub, qs, 0)
                    vis = None
                else:
                    with timing.wait("smooth.queries"):
                        qs_np = qs.cpu().numpy()
                    tracks, vis = refiner.track_frames(sub, qs_np, 0)
                    scores = None
            record = None
            if telemetry is not None:
                record = dict(start=s, frames=idxs, queries=qs, surface=ss, valid=vs, tracks=tracks,
                              visibility=vis if vis is not None else scores, poses=None)
                telemetry.setdefault("intervals", []).append(record)
            jobs.append((s, idxs, ss, vs, tracks, vis, scores, record))
        for s, idxs, ss, vs, tracks, vis, scores, record in jobs:
            with timing.span("smooth.pnp"):
                with timing.wait("smooth.correspondences"):
                    vs_np, ss_np = vs.cpu().numpy(), ss.cpu().numpy()
                if vs_np.sum() < 4:
                    for i in idxs:
                        refined[i] = poses[s]
                    continue
                if vis is None:
                    with timing.wait("smooth.visibility"):
                        vis = (scores > 0.5).cpu().numpy()
                pv = refiner.compute_pnp_batch(tracks, ss_np, np.asarray(vis) & vs_np[None], k)
                if record is not None:
                    record["poses"] = pv
                for li, fi in enumerate(idxs):
                    refined[fi] = pv[li]
    with timing.span("smooth.transforms"):
        out_poses = np.stack([refined.get(i, poses[i]) for i in range(n)]).astype(np.float32)
        if keep_coarse_translation:
            out_poses[:, :3, 3] = poses[:, :3, 3]
        return smooth_transforms(torch.as_tensor(out_poses)).numpy(), inliers


def tracker_config(path: str | None):
    """COTRACKER2 with the field overrides of a --tracker-config JSON (the
    JAX script's file; its `precision` is not a field here: the port runs
    CoTracker2 in full fp32, TF32 off)."""
    from freepose_tpu_torch.models.cotracker2 import COTRACKER2

    if not path:
        return COTRACKER2
    over = json.loads(Path(path).read_text())
    over.pop("precision", None)
    if "model_resolution" in over:
        over["model_resolution"] = tuple(over["model_resolution"])
    return dataclasses.replace(COTRACKER2, **over)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--poses", required=True, help="coarse CSV from dino_inference_video")
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--weights", default=None, help="DINOv2-B params (.npz)")
    ap.add_argument("--tracker", default=None, choices=["zncc", "cotracker2"],
                    help="point tracker; default: cotracker2 when --tracker-weights is given, else the "
                         "weight-free ZNCC chain")
    ap.add_argument("--tracker-weights", default=None, help="CoTracker2 params (.npz, JAX layout)")
    ap.add_argument("--tracker-config", default=None,
                    help="JSON file of CoTracker2Config field overrides (default: the released COTRACKER2)")
    ap.add_argument("--interval", type=int, default=12)
    ap.add_argument("--keep-coarse-translation", action="store_true", default=True)
    ap.add_argument("--exact-intervals", action="store_true",
                    help="track each interval's valid correspondence subset from host frames instead of the "
                         "default pipelined, capped intervals on the device-staged video")
    ap.add_argument("--cap", type=int, default=512,
                    help="pipelined mode: most tracked correspondences per interval (valid first, grid order)")
    ap.add_argument("--cap-buckets", type=int, nargs="+", default=[128, 256, 512],
                    help="adaptive per-interval caps for the ZNCC tracker (those at most --cap, and --cap); "
                         "pass one value equal to --cap to disable")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_fp32()

    frames = load_frame_dir(args.video_dir)
    h, w = frames.shape[1:3]
    k = default_video_intrinsics(w, h)
    coarse = sorted(read_results_csv(args.poses, t_scale=1.0), key=lambda r: r.im_id)
    mesh_id, scale = coarse[0].obj_id, coarse[0].scale
    mesh = load_obj(Path(args.mesh_dir) / str(mesh_id) / f"{mesh_id}.obj").normalized().scaled(scale)

    extractor = load_dino_extractor(args.weights, model="vitb", device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=None, feature_type="patch")

    if args.tracker is None:
        args.tracker = "cotracker2" if args.tracker_weights else "zncc"
    if args.tracker == "cotracker2":
        from freepose_tpu_torch.models.convert import load_params, random_cotracker2_params
        from freepose_tpu_torch.models.cotracker2 import CoTracker2Predictor

        tcfg = tracker_config(args.tracker_config)
        params = load_params(args.tracker_weights) if args.tracker_weights else random_cotracker2_params(tcfg)
        tracker = CoTracker2Predictor(params, tcfg, device=dev)
    else:
        tracker = PointTracker(mode="correlation", device=dev)
    refiner = TrackingRefiner(feature_fn=feature_fn, tracker=tracker, device=dev)

    poses = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in coarse]).astype(np.float32)
    n = len(frames)
    video = frames if args.exact_intervals else stage_frames(frames, dev)
    t0 = time.perf_counter()
    smoothed, inliers = smooth_track(
        refiner, mesh, video, k, poses, interval=args.interval, pipelined=not args.exact_intervals, cap=args.cap,
        keep_coarse_translation=args.keep_coarse_translation,
        cap_buckets=tuple(args.cap_buckets) if args.cap_buckets else None)
    print(f"inliers per frame: {inliers.tolist()} -> start at {int(np.argmax(inliers))}")
    dt = time.perf_counter() - t0
    results = [PoseResult(scene_id=0, im_id=r.im_id, obj_id=mesh_id, score=r.score, R=smoothed[i, :3, :3],
                          t=smoothed[i, :3, 3], bbox_visib=r.bbox_visib, scale=scale, time=dt / n)
               for i, r in enumerate(coarse)]
    out = args.out or str(Path(args.poses).with_suffix("")) + "-tracked.csv"
    write_results_csv(results, out, t_scale=1.0)
    print(f"refined track -> {out}")


if __name__ == "__main__":
    main()
