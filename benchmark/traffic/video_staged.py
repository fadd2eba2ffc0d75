"""Traffic `video_staged`: a closed loop of videos through FreePose's staged
fine-refine step (scripts/dino_inference_video.py's per-frame loop), the
object's masks handed in as a proposals JSON carries them, one video after
another: the control that bypasses SAM2.

Per video (every part in the window, as users pay it per video): the frames
staged on the card in one upload (datasets/video.py:stage_frames_hbm); per
frame, as dino_inference_video's loop runs, the frame's proposal decoded
from its RLE on the host and uploaded (pinned, one frame ahead), its crop
through `extract_proposals`, frame 0's coarse pose from the mesh's template
pack, frames 1.. through an `AutoRefineChain`, and a `StreamingInliers` fed
as the chain finalises poses (as the coupled cell feeds it). The proposals
are the object's own pixels (the benchmark drew them) with their boxes, as
the video proposal CLI writes them.

Set-up: the models of the configuration with the benchmark's seeded weights,
the mesh's template pack, the videos and their proposals JSON, and one short
video through the whole path to warm every kernel and shape the window
uses."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import configs_build, flops, synth, weights
from benchmark.reference import models as ref_models
from benchmark.reference import video_check
from benchmark.reference.control import fp8_products
from benchmark.spans import Spans, device_events, summarize

WARM_FRAMES = 17


class VideoStaged:
    def __init__(self, cfg: dict, workload: dict, seed: int, device, trace: bool):
        from freepose_tpu_torch.geometry.camera import default_video_intrinsics
        from freepose_tpu_torch.io.mesh import TriMesh
        from freepose_tpu_torch.io.proposals_json import proposal_entry
        from freepose_tpu_torch.models.cotracker import PointTracker
        from freepose_tpu_torch.models.dinov2 import DinoFeatureExtractor
        from freepose_tpu_torch.pipeline.online_pose_estimator import OnlinePoseEstimator
        from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
        from freepose_tpu_torch.pipeline.template_bank import TemplateBank
        from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner

        self.cfg, self.params, self.seed, self.dev, self.trace = cfg, workload["params"], seed, device, trace
        self.spans = Spans(False, device)
        on_card = torch.device(device).type == "cuda"
        served = configs_build.served_dtype(cfg) if on_card else torch.float32
        r, v = cfg["refine"], cfg["video"]
        self.vit_l = self._extractor(DinoFeatureExtractor, "dinov2_l", served)
        self.vit_b = self._extractor(DinoFeatureExtractor, "dinov2_b", served)
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
        # The proposals JSON of each video: one entry a frame, the object's
        # pixels as RLE and their box, as the video proposal CLI writes them.
        from freepose_tpu_torch.geometry.boxes import mask_to_bbox

        for video in self.videos:
            boxes = mask_to_bbox(video["mask"]).cpu().numpy()
            masks = video["mask"].cpu().numpy()
            video["proposals"] = [proposal_entry(boxes[t], masks[t], "mesh", 1.0, 0, t, scale=r["object_scale"])
                                  for t in range(len(masks))]
        self.sample = video_check.sample_frames(synth.sub_seed(seed, "sample"), v["frames"],
                                                self.params["check_frames"])
        self.done: list[dict] = []
        self._count_images()
        gc.collect()
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
        """Traced runs count the images each DINOv2 model featurizes."""
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
        """One video through the staged step; stops after the frame during
        which `deadline` passes. Returns its record: frames posed, poses and
        scores, the sampled frames' masks and crops."""
        from freepose_tpu_torch.datasets.video import stage_frames_hbm
        from freepose_tpu_torch.io.proposals_json import proposal_bbox_xyxy, proposal_mask
        from freepose_tpu_torch.pipeline import proposals
        from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain
        from freepose_tpu_torch.pipeline.tracking_refiner import StreamingInliers
        from freepose_tpu_torch.scripts.dino_inference_video import upload

        r, sp = self.cfg["refine"], self.spans.span
        n = video["frames"].shape[0]
        props = video["proposals"][:n]
        with sp("stage"):
            staged = stage_frames_hbm(video["frames"], device=self.dev)
        chain = AutoRefineChain(self.est, self.mesh, key, neighborhood_deg=r["neighborhood_deg"])
        conf = StreamingInliers(self.refiner, self.conf_mesh, staged, self.k, chunk=self.cfg["inliers"]["chunk"])
        rec = {"n": n, "first": None, "frames": 0, "keep": {}}
        fed = 0

        def frame_input(t):
            p = props[t]
            mask = upload(proposal_mask(p)[None], torch.device(self.dev))
            return mask, proposal_bbox_xyxy(p)[None].astype(np.float32)

        ahead = {0: frame_input(0)}
        for t in range(n):
            with sp("proposals"):
                mask_dev, boxes = ahead.pop(t)
                if t + 1 < n:
                    ahead[t + 1] = frame_input(t + 1)
                fp = proposals.extract_proposals(staged.frames[t], mask_dev, torch.as_tensor(boxes, device=self.dev),
                                                 target_size=r["template_res"], bbox_extend=r["bbox_extend"])
            if t in self.sample:
                rec["keep"][t] = fp.proposals[0].clone()
            if t == 0:
                with sp("coarse"):
                    out = self.est.coarse.estimate(fp.proposals[0], self.pack, self.k, boxes[0], r["object_scale"],
                                                   return_query_feat=False)
                    rec["first"] = (out.tcos[0].cpu().numpy(), float(out.scores[0]))
                conf.add(0, rec["first"][0])
            else:
                with sp("refine"):
                    chain.submit(fp.proposals[0], fp.masks[0], self.k, boxes[0], r["object_scale"],
                                 prev_pose=rec["first"][0] if t == 1 else None)
                with sp("inliers"):
                    while fed < len(chain.results):
                        conf.add(fed + 1, chain.results[fed][0])
                        fed += 1
            rec["frames"] = t + 1
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
        """The closed loop for `seconds`, video after video, as the coupled
        cell's window runs: a traced window first profiles one video, then
        runs `seconds` more untraced, which mfu.staged reads."""
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
        attempted = sum(rec["frames"] for rec in self.done)
        return {"metrics": {"video_frames_per_s": posed / self.window_s}, "attempted": attempted, "failed": 0,
                "frames_posed": posed, "videos_finished": sum(rec["finished"] for rec in self.done),
                "window_s": self.window_s, "video_end_s": [rec["end_s"] for rec in self.done]}

    def _profiled(self, video, key, profile, activity) -> dict:
        """_run_video under torch.profiler and with synchronising spans, with
        a marker kernel that maps the profiler's clock onto the host's (as
        the coupled cell profiles)."""
        self.spans.records.clear()
        self.spans.counts.clear()
        self.spans.enabled = True
        with profile(activities=[activity.CUDA]) as prof:
            self._sync()
            t_mark = time.perf_counter()
            torch.cuda._sleep(1000)
            self._sync()
            t0 = time.perf_counter()
            rec = self._run_video(video, key, float("inf"))
            self._sync()
            t1 = time.perf_counter()
        self.spans.enabled = False
        self.profiled = rec
        events = device_events(prof)
        marks = [s for n, s, _ in events if "spin" in n.lower() or "sleep" in n.lower()]
        offset = (t_mark - marks[0]) if marks else 0.0
        events = [e for e in events if not ("spin" in e[0].lower() or "sleep" in e[0].lower())]
        self.profile = summarize(events, (t0, t1), self.spans, offset)
        self.profile["frames"] = rec["frames"]
        self.profile["images"] = {k[len("images."):]: n for k, n in self.spans.counts.items()
                                  if k.startswith("images.")}
        return rec

    # ------------------------------------------------------------ per-layer data
    def _flops(self, rec: dict) -> float:
        """The operations of a video's posed frames: flops.video_frame's
        DINOv2 work (the query crop, the fine views featurized, the inliers'
        two DINOv2-B images) without SAM2, which this cell bypasses."""
        cfg, r = self.cfg, self.cfg["refine"]
        lv = flops.vit_image(cfg["dinov2_l"], r["template_res"], r["feature_layer"])["total"]
        bv = flops.vit_image(cfg["dinov2_b"], cfg["inliers"]["res"], cfg["dinov2_b"]["num_layers"])["total"]
        miss = rec["chain"].miss_counts
        return sum((1 + (miss[t - 1] if 1 <= t <= len(miss) else 0)) * lv + 2 * bv for t in range(rec["posed"]))

    def layer_data(self) -> dict:
        """The profiled video's spans, counters and trace in the coupled
        cell's layout (no SAM2), and the videos after it, which ran as an
        untraced window does: their operations and wall time."""
        cfg, r = self.cfg, self.cfg["refine"]
        prof_rec = self.profiled
        after = [rec for rec in self.done if prof_rec is not None and rec["index"] > prof_rec["index"]]
        data = {"span_s": {n: self.spans.total_s(n) for n in ("stage", "proposals", "coarse", "refine", "inliers")},
                "refine_frames": max(0, prof_rec["posed"] - 1) if prof_rec else 0,
                "miss_counts": [m for rec in self.done if "chain" in rec for m in rec["chain"].miss_counts],
                "profile": self.profile,
                "untraced": {"flops": sum(self._flops(rec) for rec in after),
                             "seconds": self.window_s - self.untraced_start if after else 0.0}}
        if self.profile is not None:
            vit_l = flops.vit_image(cfg["dinov2_l"], r["template_res"], r["feature_layer"])
            vit_b = flops.vit_image(cfg["dinov2_b"], cfg["inliers"]["res"], cfg["dinov2_b"]["num_layers"])
            imgs = self.profile["images"]
            data["work"] = {"k2_d64": (imgs.get("dinov2_l", 0) * vit_l["attention"]
                                       + imgs.get("dinov2_b", 0) * vit_b["attention"],
                                       imgs.get("dinov2_l", 0) * vit_l["attention_bytes"]
                                       + imgs.get("dinov2_b", 0) * vit_b["attention_bytes"])}
        return data

    # ------------------------------------------------------------ correctness
    def check(self, control: bool = False) -> dict:
        """Frees the program's state, then judges a sampled finished video on
        the coupled check's pose and inliers comparisons
        (video_check.pose_part and inliers_part, their limits) and on the
        sampled query crops' DINOv2-L patch features (features_part)."""
        finished = [rec for rec in self.done if rec["finished"]]
        if not finished:
            return {"error": "no video finished in the window"}
        rng = np.random.default_rng(synth.sub_seed(self.seed, "check"))
        rec = finished[int(rng.integers(len(finished)))]
        video = self.videos[rec["index"] % len(self.videos)]
        poses = np.stack([rec["first"][0]] + [p for p, _ in rec["chain"].results])
        scores = np.array([rec["first"][1]] + [s for _, s in rec["chain"].results])
        prog = {"masks": {t: video["mask"][t] for t in rec["keep"]},
                "crops": torch.stack([rec["keep"][t] for t in sorted(rec["keep"])]), "poses": poses,
                "scores": scores, "inliers": rec["inliers"], "inliers_thr": rec["inliers_thr"]}
        # The query crops' DINOv2-L patch features, as a refine step takes
        # them: one crop a call, through the program's extractor.
        with torch.inference_mode():
            prog["query_feats"] = torch.cat([self._feature_l(crop[None]).float() for crop in prog["crops"]])
        self._sync()
        self.est = self.refiner = self.vit_l = self.vit_b = self.pack = None
        for other in self.done:
            other.pop("chain", None)
        gc.collect()
        if torch.device(self.dev).type == "cuda":
            torch.cuda.empty_cache()
        mesh = tuple(torch.as_tensor(a, device=self.dev) for a in self.mesh_np)
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        ref_models.full_fp32()
        try:
            t0 = time.perf_counter()
            p = video_check.pose_part(self.cfg, self.seed, video, self.sample, prog, mesh, self.dev, control)
            gc.collect()
            t1 = time.perf_counter()
            q = video_check.inliers_part(self.cfg, self.seed, video, prog, self.mesh_np, self.dev, control)
            gc.collect()
            t2 = time.perf_counter()
            f = features_part(self.cfg, self.seed, prog, self.dev, control)
            t3 = time.perf_counter()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        out = {side: {**p[side], **q[side], **f[side]} for side in p}
        out["info"] = {"check_s": {"poses": t1 - t0, "inliers": t2 - t1, "features": t3 - t2},
                       "query_feat_mean": {side: f[side + "_mean"] for side in p}}
        return out


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def features_part(cfg: dict, seed: int, prog: dict, device, control: bool) -> dict:
    """The query crops' DINOv2-L patch features against the reference's of
    the same crops (the program's; `crop_err` holds them to the
    reference's): `query_feat_err` = the largest distance between a unit
    patch feature of the program and the reference's, over the sampled
    frames. Each patch is read alone, where a score's mean over the patches
    hides a precision below the configuration's; the mean distance goes to
    the info. With `control`, the control's features of the same crops in
    the program's place."""
    vit = ref_models.dinov2(cfg, "dinov2_l", seed, device)
    layer = cfg["refine"]["feature_layer"]
    ref = ref_models.patch_features(vit, prog["crops"], layer)
    sides = {"program": _unit(prog["query_feats"])}
    if control:
        with fp8_products():
            sides["control"] = ref_models.patch_features(vit, prog["crops"], layer)
    del vit
    out = {}
    for side, feats in sides.items():
        dist = torch.linalg.norm(feats - ref, dim=-1)
        out[side] = {"query_feat_err": float(dist.max())}
        out[side + "_mean"] = float(dist.mean())
    return out


def setup(cfg: dict, workload: dict, seed: int, device, trace: bool) -> VideoStaged:
    return VideoStaged(cfg, workload, seed, device, trace)
