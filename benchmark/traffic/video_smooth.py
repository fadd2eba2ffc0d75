"""Traffic `video_smooth`: a closed loop of videos through the track-refine
stage of freepose_tpu_torch (scripts/smooth_poses_video.py), one video after
another, with the coarse track handed in as the stage's CSV hands it in.

Per video (every part in the window, as users pay it per video): the
frames staged on the card in one upload (datasets/video.py:stage_frames),
then `smooth_track` as `smooth_poses_video.main` calls it: inliers on every
frame (DINOv2-B at 518² on K2, renders on K1), the best frame, intervals of
12 frames walked outward from it, each with its correspondences, CoTracker2
over the interval (cap 512 points plus the 6 x 6 support grid), host EPnP,
then the smoothing. A video counts its frames when its smoothed track is on
the host; the window ends with the video during which `seconds` passes.

The coarse track: each frame's synthetic true pose (the pose that draws the
benchmark's sprite at its place in the frame, in the video's camera) with
seeded independent jitter, a rotation of 2 degrees RMS about a random axis
and a translation of 1% of the depth RMS.

Set-up: the models from the configuration with the benchmark's seeded
weights (CoTracker2's in the released key layout, loaded by
`CoTracker2Predictor.from_state_dict`), the videos, their coarse tracks, and one
whole video through the stage to warm every kernel and shape the window
uses. A program whose `smooth_track` keeps no per-interval record
(`smooth_poses_video.INTERVAL_RECORD`) cannot be judged: set-up refuses it
at once."""
from __future__ import annotations

import bisect
import dataclasses
import gc
import math
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from benchmark import configs_build, flops, flops_cotracker2, program_spans, synth, weights
from benchmark.reference import models as ref_models
from benchmark.reference import smooth_check
from benchmark.spans import Spans, device_events, summarize


# ------------------------------------------------------------------ the coarse track
def sprite_places(seed: int, n_videos: int, frames: int, hw: tuple[int, int], object_res: int):
    """For each video of synth.make_videos(seed, ...): its offset into the
    trajectory and each frame's sprite corner (x, y), drawn again from the
    same seeded stream."""
    h, w = hw
    rng = np.random.default_rng(synth.sub_seed(seed, "paths"))
    out = []
    for _ in range(n_videos):
        start = int(rng.integers(0, frames))
        x0, x1 = rng.uniform(0.1, 0.9, size=2) * (w - object_res)
        y_mid, y_amp = rng.uniform(0.3, 0.7) * (h - object_res), rng.uniform(0, 0.2) * (h - object_res)
        xy = []
        for t in range(frames):
            s = t / max(frames - 1, 1)
            xy.append((int(round(x0 + (x1 - x0) * s)),
                       int(round(np.clip(y_mid + y_amp * math.sin(2 * math.pi * s), 0, h - object_res)))))
        out.append((start, xy))
    return out


def true_poses(seed: int, n_videos: int, frames: int, hw: tuple[int, int], object_res: int, deg_per_frame: float,
               object_scale: float) -> list[np.ndarray]:
    """[frames, 4, 4] per video: the trajectory's rotation, and the
    translation that puts the object (at `object_scale`) where the sprite
    sits at the sprite's apparent size, in the video's camera (focal the
    image diagonal, principal point the centre)."""
    h, w = hw
    f_video = math.sqrt(w * w + h * h)
    f_sprite = 600.0 * object_res / 420.0
    z = synth.RENDER_Z * (object_scale / synth.RENDER_SCALE) * (f_video / f_sprite)
    traj = synth.trajectory(seed, 2 * frames, deg_per_frame)
    out = []
    for start, xy in sprite_places(seed, n_videos, frames, hw, object_res):
        poses = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
        for t, (x, y) in enumerate(xy):
            poses[t, :3, :3] = traj[start + t, :3, :3]
            u, v = x + object_res / 2.0, y + object_res / 2.0
            poses[t, :3, 3] = ((u - w / 2.0) * z / f_video, (v - h / 2.0) * z / f_video, z)
        out.append(poses)
    return out


def jittered(seed: int, poses: np.ndarray, rot_deg: float, trans_frac: float) -> np.ndarray:
    """Each pose with independent seeded jitter: a rotation of N(0, rot_deg)
    degrees about a uniform random axis, and a translation of RMS length
    trans_frac of the depth."""
    rng = np.random.default_rng(seed)
    out = poses.copy()
    for t in range(len(poses)):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        out[t, :3, :3] = synth._axis_angle(axis, float(rng.normal(0.0, rot_deg))) @ poses[t, :3, :3]
        out[t, :3, 3] += rng.normal(0.0, trans_frac * poses[t, 2, 3] / math.sqrt(3.0), size=3)
    return out.astype(np.float32)


# ------------------------------------------------------------------ the profile
def kernels_in_spans(prof, records, select) -> tuple[float, float]:
    """(device seconds of the kernels launched inside the outermost program
    spans `select` takes, offset ns host - profiler). A kernel is placed by
    its launch (the runtime call its correlation id names, a graph's
    kernels by the graph's launch; its own start where none is found), mapped onto the records' clock by the median gap
    between the program's ranges in the trace and their records, as
    benchmark/program_trace.py maps them."""
    names = {r[0] for r in records}  # the program's ranges, on the host's rows and (their extent) the card's
    ranges, launches, kernels = defaultdict(list), {}, []
    for e in prof.profiler.kineto_results.events():
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if not on_card and e.name() in names:
            ranges[e.name()].append(e.start_ns())
        elif not on_card and e.name().startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")):
            launches[e.correlation_id()] = e.start_ns()
        elif on_card and e.duration_ns() > 0 and e.name() not in names and not e.name().startswith(("Memcpy",
                                                                                                       "Memset")):
            kernels.append((e.correlation_id(), e.start_ns(), e.duration_ns()))
    starts = defaultdict(list)
    for name, _p, t0, _t1 in records:
        starts[name].append(t0)
    diffs = [t - r for name in starts for t, r in zip(sorted(starts[name]), sorted(ranges.get(name, [])))]
    offset = statistics.median(diffs) if diffs else 0
    spans = sorted((t0, t1) for name, t0, t1, around in program_spans.nested(records)
                   if select(name) and not any(select(n) for n in around))
    s0 = [s for s, _ in spans]
    device_ns = 0
    for corr, start, dur in kernels:
        at = launches.get(corr, start) + offset
        i = bisect.bisect_right(s0, at) - 1
        if i >= 0 and spans[i][1] >= at:
            device_ns += dur
    return device_ns * 1e-9, offset


class VideoSmooth:
    def __init__(self, cfg: dict, workload: dict, seed: int, device, trace: bool):
        from freepose_tpu_torch.scripts import smooth_poses_video

        if not hasattr(smooth_poses_video, "INTERVAL_RECORD"):
            raise RuntimeError("video_smooth: this program's smooth_track keeps no record of what each interval's "
                               "tracker returned (smooth_poses_video.INTERVAL_RECORD), which the cell's check "
                               "judges; the cell cannot run on it")
        from freepose_tpu_torch.geometry.camera import default_video_intrinsics
        from freepose_tpu_torch.io.mesh import TriMesh
        from freepose_tpu_torch.models import cotracker2
        from freepose_tpu_torch.models.dinov2 import DinoFeatureExtractor
        from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner
        from freepose_tpu_torch.scripts.common import full_fp32

        self.cfg, self.params, self.seed, self.dev, self.trace = cfg, workload["params"], seed, device, trace
        on_card = torch.device(device).type == "cuda"
        full_fp32()
        v, sm = cfg["video"], cfg["smooth"]
        ct_fields = {f.name for f in dataclasses.fields(cotracker2.CoTracker2Config)}
        tcfg = cotracker2.CoTracker2Config(**{k: tuple(x) if isinstance(x, list) else x
                                              for k, x in cfg["cotracker2"].items() if k in ct_fields})
        self.tracker = cotracker2.CoTracker2Predictor.from_state_dict(
            smooth_check.cotracker2_weights(cfg, seed, device), tcfg,
            support_grid_size=cfg["cotracker2"]["support_grid"], device=device)
        served = configs_build.served_dtype(cfg) if on_card else torch.float32
        dcfg = configs_build.dinov2_config(cfg, "dinov2_b", configs_build.PORT, served)
        self.vit_b = DinoFeatureExtractor(dcfg, device=device)
        weights.load_into(self.vit_b.model, weights.make_weights(ref_models.spec_dinov2(cfg, "dinov2_b"),
                                                                 synth.sub_seed(seed, "dinov2_b"), device,
                                                                 configs_build.served_dtype(cfg)))
        self.images = 0  # DINOv2-B images featurized, which a traced run reads over its profiled video
        self.refiner = TrackingRefiner(feature_fn=self._feature_b, tracker=self.tracker, device=device)
        self.mesh_np = synth.bumpy_torus(seed, cfg["mesh"]["n_u"], cfg["mesh"]["n_v"])
        self.mesh = TriMesh(*self.mesh_np).scaled(sm["object_scale"])
        self.k = default_video_intrinsics(v["width"], v["height"], device=device)
        hw = (v["height"], v["width"])
        self.videos = synth.make_videos(seed, self.mesh_np, self.params["videos"], v["frames"], hw,
                                        v["object_res"], v["deg_per_frame"], device)
        truth = true_poses(seed, self.params["videos"], v["frames"], hw, v["object_res"], v["deg_per_frame"],
                           sm["object_scale"])
        jit = self.params["coarse_jitter"]
        self.coarse = [jittered(synth.sub_seed(seed, f"coarse{i}"), p, jit["rot_deg"], jit["trans_frac"])
                       for i, p in enumerate(truth)]
        for video in self.videos:
            video.pop("mask")  # the stage reads no mask
        gc.collect()
        self.done: list[dict] = []
        self._run_video(0)
        self._sync()

    def _sync(self) -> None:
        if torch.device(self.dev).type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _feature_b(self, imgs):
        self.images += imgs.shape[0]
        return self.vit_b(imgs, layer=None, feature_type="patch")

    # ------------------------------------------------------------ the path
    def _run_video(self, i: int) -> dict:
        """Video i of the set through smooth_poses_video's stage -> its
        record (smoothed track and inliers on the host, the telemetry)."""
        from freepose_tpu_torch.datasets.video import stage_frames
        from freepose_tpu_torch.scripts.smooth_poses_video import smooth_track

        sm = self.cfg["smooth"]
        j = i % len(self.videos)
        video = stage_frames(self.videos[j]["frames"], self.dev)
        tel: dict = {}
        smoothed, inl = smooth_track(self.refiner, self.mesh, video, self.k, self.coarse[j], interval=sm["interval"],
                                     pipelined=True, cap=sm["cap"],
                                     keep_coarse_translation=sm["keep_coarse_translation"],
                                     cap_buckets=tuple(sm["cap_buckets"]), telemetry=tel)
        return {"index": i, "video": j, "n": len(smoothed), "smoothed": smoothed, "inliers": np.asarray(inl),
                "telemetry": tel}

    def window(self, seconds: float) -> dict:
        """The closed loop: video after video until the one during which
        `seconds` passes has ended. A traced window first profiles one video
        (the next too where the profiler recorded no kernel), then runs
        `seconds` more as an untraced window does, which mfu.smooth reads."""
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        t0 = time.perf_counter()
        i, self.profile, self.profiled = 0, None, None

        def done(rec):
            rec["end_s"] = time.perf_counter() - t0
            self.done.append(rec)

        if self.trace and torch.device(self.dev).type == "cuda":
            while i < 2 and (self.profile is None or not self.profile["launches"]):
                done(self._profiled(i, profile, ProfilerActivity))
                i += 1
        self.untraced_start = time.perf_counter() - t0
        deadline = t0 + self.untraced_start + seconds
        while True:
            done(self._run_video(i))
            i += 1
            if time.perf_counter() >= deadline:
                break
        self._sync()
        self.window_s = time.perf_counter() - t0
        frames = sum(rec["n"] for rec in self.done)
        out = {"metrics": {"video_frames_per_s": frames / self.window_s}, "attempted": frames, "failed": 0,
               "frames_posed": frames, "videos_finished": len(self.done), "window_s": self.window_s,
               "video_end_s": [rec["end_s"] for rec in self.done]}
        if self.profile is not None:
            out["profiled_span_s"] = self.profile["span_s"]
        return out

    def _profiled(self, i: int, profile, activity) -> dict:
        """_run_video under torch.profiler (CPU and CUDA activity, so the
        program's tracer is on and each kernel's launch is in the trace)."""
        from freepose_tpu_torch.utils import timing

        timing.reset()
        images = self.images
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            self._sync()
            t0 = time.perf_counter()
            rec = self._run_video(i)
            self._sync()
            t1 = time.perf_counter()
        self.profiled = rec
        records = list(timing.records)
        counts = dict(timing.counts)
        try:
            ct_s, offset_ns = kernels_in_spans(prof, records, lambda n: n.startswith("cotracker2."))
        except Exception:  # a trace this torch build lays out otherwise: the metric is left out
            ct_s, offset_ns = None, None
        # The benchmark's own spans: the program's stages on the host's clock.
        spans = Spans(False)
        spans.records = [(n, a * 1e-9, b * 1e-9) for n, _p, a, b in sorted(records, key=lambda r: r[2])
                         if n.startswith("smooth.")]
        # The card's rows also hold each program range's extent, which is no
        # operation of the card.
        names = {r[0] for r in records}
        events = [e for e in device_events(prof) if e[0] not in names]
        offset = (offset_ns or 0) * 1e-9
        self.profile = summarize(events, (t0, t1), spans, offset)
        self.profile.update(frames=counts.get("smooth.frames", rec["n"]), counts=counts, cotracker2_device_s=ct_s,
                            images={"dinov2_b": self.images - images})
        # Wall seconds of the profiled video, of its outermost `cotracker2.*`
        # spans and of each `smooth.*` stage.
        spans_s = {"video": t1 - t0}
        for name, a, b, around in program_spans.nested(records):
            key = "cotracker2" if name.startswith("cotracker2.") else name if name.startswith("smooth.") else None
            if key and not any(n.startswith(key) for n in around):
                spans_s[key] = spans_s.get(key, 0.0) + (b - a) * 1e-9
        self.profile["span_s"] = spans_s
        return rec

    # ------------------------------------------------------------ per-layer data
    def _flops(self, rec: dict) -> float:
        """A video's operations: CoTracker2 on each interval it tracked, and
        DINOv2-B on a photo crop and a render of every frame of each
        confidence chunk (renders take no product and count nothing)."""
        ct, sm = self.cfg["cotracker2"], self.cfg["smooth"]
        support = ct["support_grid"] ** 2
        total = sum(flops_cotracker2.interval(ct, len(r["queries"]) + support, sm["interval"])[0]
                    for r in rec["telemetry"].get("intervals", []))
        chunk = self.cfg["inliers"]["chunk"]
        vit = flops.vit_image(self.cfg["dinov2_b"], self.cfg["inliers"]["res"], self.cfg["dinov2_b"]["num_layers"])
        return total + 2 * (-(-rec["n"] // chunk) * chunk) * vit["total"]

    def layer_data(self) -> dict:
        prof = self.profile
        after = [rec for rec in self.done if self.profiled is not None and rec["index"] > self.profiled["index"]]
        data = {"profile": prof,
                "untraced": {"flops": sum(self._flops(rec) for rec in after),
                             "seconds": self.window_s - self.untraced_start if after else 0.0}}
        if prof is not None:
            vit = flops.vit_image(self.cfg["dinov2_b"], self.cfg["inliers"]["res"], self.cfg["dinov2_b"]["num_layers"])
            n = prof["images"]["dinov2_b"]
            data["work"] = {"k2_d64": (n * vit["attention"], n * vit["attention_bytes"])}
        if prof is not None and prof.get("cotracker2_device_s"):
            c = prof["counts"]
            data["cotracker2"] = {"work": flops_cotracker2.work(self.cfg["cotracker2"], c.get("cotracker2.frames", 0),
                                                               c.get("cotracker2.windows", 0),
                                                               c.get("cotracker2.iters", 0),
                                                               c.get("cotracker2.points", 0)),
                                  "device_s": prof["cotracker2_device_s"]}
        return data

    # ------------------------------------------------------------ correctness
    def check(self, control: bool = False) -> dict:
        """Frees the program's models, then judges a finished video drawn from
        the seed (smooth_check.judge) on its best frame's interval and
        `check_intervals` - 1 others."""
        if not self.done:
            return {"error": "no video finished in the window"}
        rng = np.random.default_rng(synth.sub_seed(self.seed, "check"))
        rec = self.done[int(rng.integers(len(self.done)))]
        tel = rec["telemetry"]
        intervals = tel.get("intervals", [])
        if not intervals or "inliers_threshold" not in tel:
            return {"error": "smooth_track recorded no interval"}
        host = [{key: (r[key].cpu().numpy() if torch.is_tensor(r[key]) else r[key]) for key in r} for r in intervals]
        best = int(np.argmax(rec["inliers"]))
        prog = {"coarse": self.coarse[rec["video"]], "smoothed": rec["smoothed"], "inliers": rec["inliers"],
                "inliers_thr": tel["inliers_threshold"], "intervals": host,
                "checked": smooth_check.check_intervals(synth.sub_seed(self.seed, "intervals"), host, best,
                                                        self.params["check_intervals"])}
        video = self.videos[rec["video"]]
        self._sync()
        self.tracker = self.refiner = self.vit_b = None
        for other in self.done:
            if other is not rec:
                other.pop("telemetry", None)
        gc.collect()
        if torch.device(self.dev).type == "cuda":
            torch.cuda.empty_cache()
        return smooth_check.judge(self.cfg, self.seed, video, prog, self.mesh_np, self.dev, control)


def setup(cfg: dict, workload: dict, seed: int, device, trace: bool) -> VideoSmooth:
    return VideoSmooth(cfg, workload, seed, device, trace)
