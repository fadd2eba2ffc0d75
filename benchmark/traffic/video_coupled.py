"""Traffic `video_coupled`: a closed loop of videos through the coupled
video step of freepose_tpu_torch, one video after another.

Per video (every part in the window, as users pay it per video): the
frames staged on the card in one upload (datasets/video.py:
stage_frames_hbm), the object box-prompted on frame 0, SAM2 through
`propagate_batched`, each batch's masks and frames through
`proposals_from_masks_video`, frame 0's coarse pose from the mesh's
template pack, frames 1.. through an `AutoRefineChain`, and a
`StreamingInliers` fed as the chain finalises poses. Random SAM2 weights
track nothing in particular, so each batch's SAM2 mask is OR-ed with the
object's own pixels (the benchmark drew them) before the crops: the crops
still depend on SAM2's output, and hold the object.

Set-up: the models from the configuration with the benchmark's seeded
weights, the mesh's template pack, the videos, and one short video through
the whole path to warm every kernel and shape the window uses."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import configs_build, flops, synth, weights
from benchmark.reference import models as ref_models
from benchmark.reference import video_check
from benchmark.spans import Spans, device_events, summarize

WARM_FRAMES = 17  # the prompt frame, one full SAM2 batch, one more


class VideoCoupled:
    def __init__(self, cfg: dict, workload: dict, seed: int, device, trace: bool):
        from freepose_tpu_torch.geometry.camera import default_video_intrinsics
        from freepose_tpu_torch.io.mesh import TriMesh
        from freepose_tpu_torch.models.cotracker import PointTracker
        from freepose_tpu_torch.models.dinov2 import DinoFeatureExtractor
        from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
        from freepose_tpu_torch.pipeline.online_pose_estimator import OnlinePoseEstimator
        from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
        from freepose_tpu_torch.pipeline.template_bank import TemplateBank
        from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner

        self.cfg, self.params, self.seed, self.dev, self.trace = cfg, workload["params"], seed, device, trace
        # Spans and counts are kept while the traced window's profiled video
        # runs (_profiled), and only then synchronise.
        self.spans = Spans(False, device)
        on_card = torch.device(device).type == "cuda"
        served = configs_build.served_dtype(cfg) if on_card else torch.float32
        r, v = cfg["refine"], cfg["video"]

        pcfg = configs_build.sam2_video_config(cfg, configs_build.PORT, served, on_card)
        self.predictor = Sam2VideoPredictor(pcfg, device=device)
        weights.load_into(self.predictor.model, weights.make_weights(
            ref_models.spec_sam2(cfg), synth.sub_seed(seed, "sam2"), device, configs_build.served_dtype(cfg)))
        self.vit_l = self._extractor(DinoFeatureExtractor, "dinov2_l", served)
        self.vit_b = self._extractor(DinoFeatureExtractor, "dinov2_b", served)
        gc.collect()

        self.mesh_np = synth.bumpy_torus(seed, cfg["mesh"]["n_u"], cfg["mesh"]["n_v"])
        self.mesh = TriMesh(*self.mesh_np)
        renderer = TemplateRenderer(n_poses=r["n_coarse_poses"], resolution=r["template_res"], device=device)
        bank = TemplateBank(self._feature_l, renderer, cache_size=r["pack_cache"], device=device)
        self.est = OnlinePoseEstimator(self._feature_l, bank, renderer, n_coarse_poses=r["n_coarse_poses"],
                                       n_fine_poses=r["n_fine_poses"], n_neighbors=r["n_neighbors"],
                                       extractor=self.vit_l, feature_layer=r["feature_layer"],
                                       fine_cache_capacity=r["fine_cache"])
        self.pack = bank.get("mesh", self.mesh)
        self.refiner = TrackingRefiner(feature_fn=lambda imgs: self.vit_b(imgs, layer=None, feature_type="patch"),
                                       tracker=PointTracker(device=device), device=device)
        self.conf_mesh = self.mesh.scaled(r["object_scale"])
        self.k = default_video_intrinsics(v["width"], v["height"], device=device)
        self.videos = synth.make_videos(seed, self.mesh_np, self.params["videos"], v["frames"],
                                        (v["height"], v["width"]), v["object_res"], v["deg_per_frame"], device)
        self.sample = video_check.sample_frames(synth.sub_seed(seed, "sample"), v["frames"],
                                                self.params["check_frames"])
        self.done: list[dict] = []
        self._count_images()
        warm = dict(self.videos[0], frames=self.videos[0]["frames"][:min(WARM_FRAMES, v["frames"])])
        self._run_video(warm, "warm", deadline=float("inf"))
        self._sync()

    # ------------------------------------------------------------ set-up
    def _extractor(self, cls, key: str, served):
        cfg = configs_build.dinov2_config(self.cfg, key, configs_build.PORT, served)
        ext = cls(cfg, device=self.dev)
        weights.load_into(ext.model, weights.make_weights(ref_models.spec_dinov2(self.cfg, key),
                                                          synth.sub_seed(self.seed, key), self.dev,
                                                          configs_build.served_dtype(self.cfg)))
        return ext

    def _feature_l(self, imgs):
        return self.vit_l(imgs, layer=self.cfg["refine"]["feature_layer"], feature_type="patch")

    def _count_images(self) -> None:
        """Traced runs count the images each DINOv2 model featurizes, at the
        call into the model (the rooflines' work)."""
        for key, ext in (("dinov2_l", self.vit_l), ("dinov2_b", self.vit_b)):
            forward = ext.model.forward

            def counted(images, *args, _f=forward, _k=key, **kwargs):
                self.spans.count(f"images.{_k}", images.shape[0])
                return _f(images, *args, **kwargs)
            ext.model.forward = counted

    def _sync(self) -> None:
        if torch.device(self.dev).type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------ the path
    def _run_video(self, video: dict, key: str, deadline: float) -> dict:
        """One video through the coupled step; stops after the batch during
        which `deadline` passes. Returns its record: frames posed (pose
        rows on the host), poses and scores, every frame's low-res SAM2 mask
        (the candidate SAM2 chose, for the reference to follow) and the
        sampled frames' outputs."""
        from freepose_tpu_torch.datasets.video import stage_frames_hbm
        from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain
        from freepose_tpu_torch.pipeline.proposals import proposals_from_masks_video
        from freepose_tpu_torch.pipeline.tracking_refiner import StreamingInliers

        r, sp = self.cfg["refine"], self.spans.span
        n = video["frames"].shape[0]
        with sp("stage"):
            staged = stage_frames_hbm(video["frames"], device=self.dev)
        state = self.predictor.init_state(staged)
        self.predictor.add_new_points_or_box(state, 0, obj_id=0, box=video["box0"])
        chain = AutoRefineChain(self.est, self.mesh, key, neighborhood_deg=r["neighborhood_deg"])
        conf = StreamingInliers(self.refiner, self.conf_mesh, staged, self.k, chunk=self.cfg["inliers"]["chunk"])
        rec = {"n": n, "first": None, "sam2_frames": 0, "keep": {}, "lows": {}}
        fed = 0
        batches = self.predictor.propagate_batched(state, chunk=self.cfg["video"]["sam2_chunk"])
        while True:
            with sp("sam2"):
                item = next(batches, None)
            if item is None:
                break
            ts, lows, highs, frames_b = item
            rec["sam2_frames"] += len(ts)
            with sp("proposals"):
                raw = highs[:, 0]
                crops, cmasks, bboxes = proposals_from_masks_video(frames_b, raw | video["mask"][ts[0]:ts[-1] + 1],
                                                                   r["template_res"], r["bbox_extend"])
            for z, t in enumerate(ts):
                rec["lows"][t] = lows[z, 0]
                if t in self.sample:
                    rec["keep"][t] = (raw[z].clone(), crops[z].clone())
                if t == 0:
                    with sp("coarse"):
                        out = self.est.coarse.estimate(crops[z], self.pack, self.k, bboxes[z], r["object_scale"])
                        rec["first"] = (out.tcos[0].cpu().numpy(), float(out.scores[0]))
                    conf.add(0, rec["first"][0])
                else:
                    with sp("refine"):
                        chain.submit(crops[z], cmasks[z], self.k, bboxes[z], r["object_scale"],
                                     prev_pose=rec["first"][0] if t == 1 else None)
            with sp("inliers"):
                while fed < len(chain.results):
                    conf.add(fed + 1, chain.results[fed][0])
                    fed += 1
            if time.perf_counter() >= deadline:
                rec.update(posed=1 + len(chain.results), chain=chain, finished=False)
                return rec
        with sp("refine"):
            results = chain.finalize_all()
        with sp("inliers"):
            while fed < len(results):
                conf.add(fed + 1, results[fed][0])
                fed += 1
            counts, thr = conf.finalize()
        rec.update(posed=n, chain=chain, finished=True, inliers=counts, inliers_thr=thr)
        return rec

    def window(self, seconds: float) -> dict:
        """The closed loop for `seconds`: video after video (the set-up's
        videos in turn). A traced window first profiles one video (the next
        one too where the profiler recorded no kernel, as it now and then
        does), then runs `seconds` more as an untraced window does, which
        mfu.video reads. -> the window's e2e numbers."""
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        t0 = time.perf_counter()
        i, self.profile, self.profiled = 0, None, None

        def done(rec):
            rec["index"] = i
            rec["end_s"] = time.perf_counter() - t0
            self.done.append(rec)

        if self.trace and torch.device(self.dev).type == "cuda":
            while i < 2 and (self.profile is None or not self.profile["launches"]):
                done(self._profiled(self.videos[i % len(self.videos)], f"video{i}", profile, ProfilerActivity))
                i += 1
        self.untraced_start = time.perf_counter() - t0
        deadline = t0 + self.untraced_start + seconds
        while True:
            done(self._run_video(self.videos[i % len(self.videos)], f"video{i}", deadline))
            i += 1
            if time.perf_counter() >= deadline:
                break
        self.window_s = time.perf_counter() - t0
        posed = sum(rec["posed"] for rec in self.done)
        attempted = sum(rec["sam2_frames"] for rec in self.done)
        return {"metrics": {"video_frames_per_s": posed / self.window_s}, "attempted": attempted, "failed": 0,
                "frames_posed": posed, "videos_finished": sum(rec["finished"] for rec in self.done),
                "window_s": self.window_s, "video_end_s": [rec["end_s"] for rec in self.done]}

    def _profiled(self, video, key, profile, activity) -> dict:
        """_run_video under torch.profiler and with synchronising spans (the
        first video of a traced window), with a marker kernel that maps the
        profiler's clock onto the host's."""
        self.spans.records.clear()
        self.spans.counts.clear()
        self.spans.enabled = True
        with profile(activities=[activity.CUDA]) as prof:
            self._sync()
            t_mark = time.perf_counter()
            torch.cuda._sleep(1000)
            self._sync()
            t0 = time.perf_counter()
            rec = self._run_video(video, key, float("inf"))  # the profiled video runs to its end
            self._sync()
            t1 = time.perf_counter()
        self.spans.enabled = False
        self.profiled = rec
        events = device_events(prof)
        marks = [s for n, s, _ in events if "spin" in n.lower() or "sleep" in n.lower()]
        offset = (t_mark - marks[0]) if marks else 0.0
        events = [e for e in events if not ("spin" in e[0].lower() or "sleep" in e[0].lower())]
        self.profile = summarize(events, (t0, t1), self.spans, offset)
        self.profile["frames"] = rec["sam2_frames"]
        self.profile["images"] = {k[len("images."):]: n for k, n in self.spans.counts.items()
                                  if k.startswith("images.")}
        return rec

    # ------------------------------------------------------------ per-layer data
    def _flops(self, rec: dict) -> float:
        """The operations of a video's posed frames (flops.video_frame), with
        the fine views its chain's miss counts say it featurized."""
        miss = rec["chain"].miss_counts
        return sum(flops.video_frame(self.cfg, t, miss[t - 1] if 1 <= t <= len(miss) else 0)
                   for t in range(rec["posed"]))

    def layer_data(self) -> dict:
        """The profiled video's spans, counters and trace, and the videos
        after it, which ran as an untraced window does: their operations
        and wall time."""
        cfg = self.cfg
        r = cfg["refine"]
        misses = [m for rec in self.done for m in rec["chain"].miss_counts]
        vit_l = flops.vit_image(cfg["dinov2_l"], r["template_res"], r["feature_layer"])
        vit_b = flops.vit_image(cfg["dinov2_b"], cfg["inliers"]["res"], cfg["dinov2_b"]["num_layers"])
        prof_rec = self.profiled
        after = [rec for rec in self.done if prof_rec is not None and rec["index"] > prof_rec["index"]]
        data = {"span_s": {n: self.spans.total_s(n) for n in ("stage", "sam2", "proposals", "coarse", "refine",
                                                             "inliers")},
                "sam2_frames": prof_rec["sam2_frames"] if prof_rec else 0,
                "refine_frames": max(0, prof_rec["posed"] - 1) if prof_rec else 0,
                "miss_counts": misses, "profile": self.profile,
                "untraced": {"flops": sum(self._flops(rec) for rec in after),
                             "seconds": self.window_s - self.untraced_start if after else 0.0}}
        if self.profile is not None:
            n = self.profile["frames"]
            att = [flops.sam2_frame(cfg["sam2"], t) for t in range(n)]
            imgs = self.profile["images"]
            data["work"] = {
                "k2_d64": (imgs.get("dinov2_l", 0) * vit_l["attention"] + imgs.get("dinov2_b", 0) * vit_b["attention"],
                           imgs.get("dinov2_l", 0) * vit_l["attention_bytes"]
                           + imgs.get("dinov2_b", 0) * vit_b["attention_bytes"]),
                "sam2_attention": (sum(a["attention"] for a in att), sum(a["attention_bytes"] for a in att))}
        return data

    # ------------------------------------------------------------ correctness
    def check(self, control: bool = False) -> dict:
        """Frees the program's state, then judges a sampled finished video
        (video_check.judge)."""
        finished = [rec for rec in self.done if rec["finished"]]
        if not finished:
            return {"error": "no video finished in the window"}
        rng = np.random.default_rng(synth.sub_seed(self.seed, "check"))
        rec = finished[int(rng.integers(len(finished)))]
        video = self.videos[rec["index"] % len(self.videos)]
        poses = np.stack([rec["first"][0]] + [p for p, _ in rec["chain"].results])
        scores = np.array([rec["first"][1]] + [s for _, s in rec["chain"].results])
        prog = {"masks": {t: m for t, (m, _) in rec["keep"].items()}, "lows": rec["lows"],
                "crops": torch.stack([rec["keep"][t][1] for t in sorted(rec["keep"])]), "poses": poses,
                "scores": scores, "inliers": rec["inliers"], "inliers_thr": rec["inliers_thr"]}
        self._sync()
        self.predictor = self.est = self.refiner = self.vit_l = self.vit_b = self.pack = None
        for other in self.done:
            other.pop("chain", None)
            if other is not rec:
                other.pop("lows", None)
        gc.collect()
        if torch.device(self.dev).type == "cuda":
            torch.cuda.empty_cache()
        return video_check.judge(self.cfg, self.seed, video, self.sample, prog, self.mesh_np, self.dev, control)


def setup(cfg: dict, workload: dict, seed: int, device, trace: bool) -> VideoCoupled:
    return VideoCoupled(cfg, workload, seed, device, trace)
