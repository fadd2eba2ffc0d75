"""The comparison that decides `correct` in the smooth cell
(`video.smooth.cotracker2`): the program's track-refine pass over one
finished video (`smooth_track` with CoTracker2) against the plain
reference, from what the program recorded (its `telemetry`: each interval's
query points, surface points, valid flags, tracks, visibility and EPnP
poses before smoothing; the confidence threshold of its inliers).

  * CoTracker2 (cotracker2.py at float32, TF32 off): on the checked
    intervals (the best frame's and one drawn from the seed) the reference
    tracks the program's own query points through the interval's frames
    (those the interval holds; the padding that fills its last window is
    not compared). `track_err` = the mean distance in pixels at the input
    resolution between the program's track and the reference's, over the
    points both take as visible (the largest over the checked intervals);
    `vis_gap` = the largest distance from 0.9 of a
    reference visibility whose side of 0.9 the program decided otherwise.
  * Correspondences and EPnP: the reference renders the shrunk mesh at the
    interval's start pose and bins its own surface samples to the 37 x 37
    patch grid (the port's `compute_2d3d_correspondences`, frozen here);
    each program query sits at a patch centre, whose reference surface
    point and valid flag it takes. The frozen EPnP (frozen/pnp.py) solves
    every frame of the interval from the program's tracks and visibility at
    those surface points; `pnp_rot_err` (degrees) and `pnp_trans_err`
    (relative to the reference translation's length) are the largest
    departures of the program's EPnP poses from those.
  * Smoothing: the frozen smoothing (frozen/se3.py) of every interval's
    program EPnP poses, the coarse pose where no interval reaches and the
    coarse translations kept, against the program's output; `smooth_err`
    = the largest difference of an entry of [R | t / |t|].
  * Inliers: the reference's patch cosines of every frame at the coarse
    poses (inliers.py); `inliers_rank` and `inliers_gap` as
    video_check.inliers_part reads them, at the program's threshold.

With `control`, the same numbers for the control in the program's place:
the reference with every product's operands rounded to TF32 (10 mantissa
bits, the precision below the configuration's float32), on the program's
query points; its EPnP and smoothing take no product and read 0."""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import synth, weights
from benchmark.reference import cotracker2, inliers, models
from benchmark.reference.frozen.camera import crop_bbox_around_projection, default_video_intrinsics, update_k_with_crop
from benchmark.reference.frozen.pnp import epnp
from benchmark.reference.frozen.rasterizer import RasterSettings, render_meshes
from benchmark.reference.frozen.sampling import resize_area
from benchmark.reference.frozen.se3 import smooth_transforms

RES, PATCH = 518, 14
GRID = RES // PATCH
SURFACE_SAMPLES, SHRINK = 10000, 0.8  # TrackingRefiner.n_surface_samples; the correspondences' render shrink
SETTINGS = RasterSettings(resolution=RES, tile=37, max_faces_per_tile=256)


# ------------------------------------------------------------------ the model and its weights
def config(cfg: dict) -> cotracker2.CoTracker2Config:
    ct = cfg["cotracker2"]
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in ct.items()
              if k in cotracker2.CoTracker2Config.__dataclass_fields__}
    return cotracker2.CoTracker2Config(**fields)


def spec(cfg: dict) -> cotracker2.CoTracker2:
    with torch.device("meta"):
        return cotracker2.CoTracker2(config(cfg))


def cotracker2_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The benchmark's CoTracker2 weights for a seed, in the released key
    layout (benchmark/weights.py's rules at float32), then the flow head and
    the track-feature update scaled and the visibility probe's bias moved by
    the configuration's `random_weights` (random weights make the iterated
    tracker chaotic, and put every visibility far from 0.9)."""
    w = weights.make_weights(spec(cfg), synth.sub_seed(seed, "cotracker2"), device, torch.float32)
    rw = cfg["random_weights"]
    for head, key in (("updateformer.flow_head", "flow_head_scale"), ("track_feat_updater.0", "feature_update_scale")):
        for name in (f"{head}.weight", f"{head}.bias"):
            w[name] = w[name] * rw.get(key, 1.0)
    w["vis_predictor.0.bias"] = w["vis_predictor.0.bias"] + rw["visibility_bias"]
    return w


def model(cfg: dict, seed: int, device) -> cotracker2.CoTracker2:
    m = cotracker2.CoTracker2(config(cfg)).to(device).eval()
    weights.load_into(m, cotracker2_weights(cfg, seed, device))
    return m


# ------------------------------------------------------------------ the control
def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest) in float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)


@contextlib.contextmanager
def tf32_products():
    """Every F.linear, F.conv2d and reference CoTracker2 product takes
    TF32-rounded operands and accumulates in float32, as TF32 tensor cores
    do, on any device."""
    linear, conv2d, matmul = F.linear, F.conv2d, cotracker2.matmul

    def q_linear(x, w, b=None):
        return linear(to_tf32(x), to_tf32(w), b)

    def q_conv2d(x, w, b=None, *args, **kwargs):
        return conv2d(to_tf32(x), to_tf32(w), b, *args, **kwargs)

    def q_matmul(a, b):
        return matmul(to_tf32(a), to_tf32(b))

    F.linear, F.conv2d, cotracker2.matmul = q_linear, q_conv2d, q_matmul
    try:
        yield
    finally:
        F.linear, F.conv2d, cotracker2.matmul = linear, conv2d, matmul


# ------------------------------------------------------------------ correspondences
def bin_surface_to_patches(surf, pose, new_k, mask37, bbox):
    """The port's tracking_refiner._bin_surface_to_patches, frozen: per
    patch of the 37 x 37 crop grid the surface sample of the smallest key
    (centre-distance bin · 100 + depth), ties to the lower index -> (query
    [G², 2] image pixels at the patch centres, surface [G², 3], valid
    [G²])."""
    n, dev = surf.shape[0], surf.device
    cam = surf @ pose[:3, :3].T + pose[:3, 3]
    uvw = cam @ new_k.T
    uv = uvw[:, :2] / torch.clamp(uvw[:, 2:3], min=1e-6)
    patch_f = torch.floor(uv / PATCH)
    pxy = patch_f.to(torch.int32)
    inside = (pxy[:, 0] >= 0) & (pxy[:, 0] < GRID) & (pxy[:, 1] >= 0) & (pxy[:, 1] < GRID) & (cam[:, 2] > 1e-4)
    pid = torch.where(inside, pxy[:, 1] * GRID + pxy[:, 0], GRID * GRID).long()
    off = uv / PATCH - patch_f - 0.5
    cbin = torch.clamp(((off * off).sum(dim=-1) * 16).to(torch.int32), 0, 15).to(torch.float32)
    key = torch.where(inside, cbin * 100.0 + torch.clamp(cam[:, 2], 0.0, 99.0), torch.inf)
    order = torch.argsort(key, stable=True)
    first = torch.full((GRID * GRID + 1,), n, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, pid[order], torch.arange(n, device=dev), reduce="amin")[:GRID * GRID]
    surface = surf[order[first.clamp(max=n - 1)]]
    g = torch.arange(GRID * GRID, device=dev)
    centres = torch.stack([g % GRID, g // GRID], dim=-1).to(torch.float32) * PATCH + PATCH * 0.5
    x1, y1, x2, y2 = bbox
    query = centres / RES * torch.stack([x2 - x1, y2 - y1]) + torch.stack([x1, y1])
    return query, surface, (first < n) & mask37.reshape(-1)


def correspondences(mesh_np, pose: torch.Tensor, k: torch.Tensor):
    """The reference's correspondences at a start pose: mesh_np the object
    (vertices, faces, colours) at its scale; the crop box around the
    projected model points, the mesh shrunk by 0.8 rendered at the crop's
    intrinsics, its 37 x 37 coverage, the binning -> (query, surface, valid,
    bbox)."""
    verts, faces, colors = mesh_np
    dev = pose.device
    pts100 = torch.as_tensor(inliers.sample_surface(verts, faces, inliers.SURFACE_POINTS, inliers.SURFACE_SEED),
                             device=dev)
    surf = torch.as_tensor(inliers.sample_surface(verts, faces, SURFACE_SAMPLES, 0), device=dev)
    bbox = crop_bbox_around_projection(pose[None], pts100, k, RES, RES, lamb=1.4)[0]
    new_k = update_k_with_crop(k, bbox[None], RES, RES)[0]
    v = torch.as_tensor(verts * np.float32(SHRINK), device=dev)
    f = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    valid = torch.ones(f.shape[0], dtype=torch.bool, device=dev)
    _, depth = render_meshes(v, torch.as_tensor(colors, device=dev), f, valid, pose[None], new_k[None], SETTINGS)
    mask37 = resize_area((depth[0] > 0).float(), (GRID, GRID)) > 0.5
    return (*bin_surface_to_patches(surf, pose, new_k, mask37, bbox), bbox)


def patch_of(query: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """The patch (row-major on the 37 x 37 grid) whose centre each query
    pixel [N, 2] marks in the crop `bbox`."""
    x1, y1, x2, y2 = bbox
    crop = (query - torch.stack([x1, y1])) / torch.stack([x2 - x1, y2 - y1]) * RES
    gxy = torch.round((crop - PATCH * 0.5) / PATCH).long().clamp(0, GRID - 1)
    return gxy[:, 1] * GRID + gxy[:, 0]


# ------------------------------------------------------------------ the numbers
def rotation_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle between rotations [..., 3, 3], in degrees, from their
    difference (|A - B|_F = 2√2 sin(θ/2)): 0 for equal matrices, where the
    trace formula reads up to ~0.1 degrees off float32 rotations that are
    orthonormal only to rounding."""
    d = torch.linalg.norm((a.double() - b.double()).flatten(-2), dim=-1)
    return torch.rad2deg(2.0 * torch.arcsin((d / (2.0 * math.sqrt(2.0))).clamp(max=1.0)))


def track_numbers(tracks, visible, ref_tracks, ref_prob, ref_visible) -> dict:
    """track_err: the mean distance over the points visible on both sides
    (the iterated tracker lifts rounding at a few points ~50-fold, which a
    maximum would read; a change that moves the tracks moves the mean);
    vis_gap over the decisions that differ."""
    both = visible & ref_visible
    dist = torch.linalg.norm(tracks - ref_tracks, dim=-1)
    differ = visible != ref_visible
    return {"track_err": float(dist[both].mean()) if bool(both.any()) else 0.0,
            "vis_gap": float((ref_prob[differ] - cotracker2.VISIBILITY_THRESHOLD).abs().max())
            if bool(differ.any()) else 0.0}


def pnp_numbers(prog_poses: np.ndarray, tracks: torch.Tensor, visible: torch.Tensor, surface: torch.Tensor,
                valid: torch.Tensor, k: torch.Tensor) -> dict:
    """The frozen EPnP of an interval on the host from `tracks` [S, N, 2],
    `visible` [S, N] and the reference's `surface` [N, 3] and `valid` [N],
    against the program's poses [S, 4, 4]."""
    ref = epnp(surface.cpu(), tracks.cpu(), k.cpu(), visible.cpu() & valid.cpu()[None])
    prog = torch.as_tensor(prog_poses, dtype=torch.float32)
    dt = (torch.linalg.norm(prog[:, :3, 3] - ref[:, :3, 3], dim=-1)
          / torch.linalg.norm(ref[:, :3, 3], dim=-1).clamp(min=1e-6))  # a degenerate solve may put t at 0
    return {"pnp_rot_err": float(rotation_deg(prog[:, :3, :3], ref[:, :3, :3]).max()),
            "pnp_trans_err": float(dt.max())}


def smooth_err(coarse: np.ndarray, intervals: list[dict], smoothed: np.ndarray) -> float:
    """The frozen smoothing of the program's pre-smoothing poses against its
    smoothed output: the largest entry difference of [R | t / |t|]."""
    n = len(coarse)
    pre = torch.as_tensor(np.asarray(coarse, np.float32)).clone()
    for rec in intervals:
        if rec["poses"] is not None:
            for li, t in enumerate(rec["frames"]):
                pre[t, :3, :3] = torch.as_tensor(rec["poses"][li][:3, :3])
    ref = smooth_transforms(pre)
    prog = torch.as_tensor(np.asarray(smoothed, np.float32))

    def rt(p):
        return torch.cat([p[:, :3, :3], (p[:, :3, 3] / torch.linalg.norm(p[:, :3, 3], dim=-1, keepdim=True))[..., None]],
                         dim=-1)
    return float((rt(prog[:n]) - rt(ref)).abs().max())


def check_intervals(seed: int, intervals: list[dict], best: int, k: int) -> list[int]:
    """The intervals to check: the one starting at the best frame and k - 1
    others drawn from the seed."""
    first = next(i for i, rec in enumerate(intervals) if rec["start"] == best)
    rest = [i for i in range(len(intervals)) if i != first]
    rng = np.random.default_rng(seed)
    return [first] + sorted(int(x) for x in rng.choice(rest, size=min(k - 1, len(rest)), replace=False))


def _interval_frames(video: dict, rec: dict, step: int, device) -> torch.Tensor:
    n = video["frames"].shape[0]
    idxs = rec["frames"]
    pad = [min(max(i, 0), n - 1) for i in idxs] + [idxs[-1]] * (step - len(idxs))
    return torch.as_tensor(video["frames"][pad], device=device).float()


def cotracker_part(cfg: dict, seed: int, video: dict, prog: dict, mesh_np, device, control: bool) -> dict:
    """prog: "intervals" (host records) and "checked" (their indices)."""
    ct = cfg["cotracker2"]
    h, w = video["frames"].shape[1:3]
    k = default_video_intrinsics(w, h, device=device)
    verts, faces, colors = mesh_np
    obj = (verts * np.float32(cfg["smooth"]["object_scale"]), faces, colors)
    net = model(cfg, seed, device)
    sides = {"program": [], "control": []} if control else {"program": []}
    for i in prog["checked"]:
        rec = prog["intervals"][i]
        frames = _interval_frames(video, rec, cfg["smooth"]["interval"], device)
        queries = torch.as_tensor(rec["queries"], device=device)
        real = len(rec["frames"])  # the interval's own frames; the rest repeat its last to fill the window
        tracks = torch.as_tensor(rec["tracks"], device=device)[:real]
        visible = torch.as_tensor(rec["visibility"], device=device)[:real]
        ref_t, ref_p, ref_v = (x[:real] for x in cotracker2.predict(net, frames, queries, ct["support_grid"]))
        start = torch.as_tensor(prog["coarse"][rec["start"]], device=device)
        _, surface, valid, bbox = correspondences(obj, start, k)
        g = patch_of(queries, bbox)
        row = {**track_numbers(tracks, visible, ref_t, ref_p, ref_v),
               **(pnp_numbers(rec["poses"][:real], tracks, visible, surface[g], valid[g], k) if rec["poses"] is not None
                  else {"pnp_rot_err": 0.0, "pnp_trans_err": 0.0})}
        sides["program"].append(row)
        if control:
            with tf32_products():
                c_t, c_p, c_v = (x[:real] for x in cotracker2.predict(net, frames, queries, ct["support_grid"]))
            sides["control"].append({**track_numbers(c_t, c_v, ref_t, ref_p, ref_v),
                                     "pnp_rot_err": 0.0, "pnp_trans_err": 0.0})
    del net
    return {side: {key: max(r[key] for r in rows) for key in rows[0]} for side, rows in sides.items()}


def inliers_part(cfg: dict, seed: int, video: dict, prog: dict, mesh_np, device, control: bool) -> dict:
    """The inliers' numbers at the coarse poses (video_check.inliers_part's),
    the control's from its own TF32-rounded cosines."""
    verts, faces, colors = mesh_np
    mesh = (verts * np.float32(cfg["smooth"]["object_scale"]), faces, colors)
    h, w = video["frames"].shape[1:3]
    k = default_video_intrinsics(w, h, device=device)
    vit = models.dinov2(cfg, "dinov2_b", seed, device)
    crops, renders, masks = inliers.crops_and_renders(video["frames"], prog["coarse"], mesh, k, device)
    conf = inliers.confidences(vit, crops, renders, masks)
    thr = prog["inliers_thr"]
    out = {"program": {"inliers_rank": inliers.rank_err(conf, thr),
                       "inliers_gap": inliers.count_gap(conf, thr, prog["inliers"])}}
    if control:
        with tf32_products():
            c_conf = inliers.confidences(vit, crops, renders, masks)
        c_thr = inliers.threshold(c_conf)
        c_counts = (c_conf > c_thr).sum(dim=(1, 2)).cpu().numpy()
        out["control"] = {"inliers_rank": inliers.rank_err(conf, c_thr),
                          "inliers_gap": inliers.count_gap(conf, c_thr, c_counts)}
    del vit, crops, renders
    return out


def judge(cfg: dict, seed: int, video: dict, prog: dict, mesh_np, device, control: bool = False) -> dict:
    """prog: "coarse" [T, 4, 4], "smoothed" [T, 4, 4], "inliers" [T],
    "inliers_thr", "intervals" (host records of every interval), "checked"
    -> {"program": {number: value}, "control": {...} (with control), "info"}.
    Runs at float32 with TF32 off; restores the settings."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    models.full_fp32()
    try:
        t0 = time.perf_counter()
        c = cotracker_part(cfg, seed, video, prog, mesh_np, device, control)
        gc.collect()
        t1 = time.perf_counter()
        q = inliers_part(cfg, seed, video, prog, mesh_np, device, control)
        t2 = time.perf_counter()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out = {side: {**c[side], **q[side]} for side in c}
    out["program"]["smooth_err"] = smooth_err(prog["coarse"], prog["intervals"], prog["smoothed"])
    if control:
        out["control"]["smooth_err"] = 0.0
    out["info"] = {"check_s": {"cotracker2": t1 - t0, "inliers": t2 - t1},
                   "checked_intervals": [prog["intervals"][i]["start"] for i in prog["checked"]]}
    for side in out:
        if side != "info":
            out[side] = {key: v if math.isfinite(v) else float("inf") for key, v in out[side].items()}
    return out
