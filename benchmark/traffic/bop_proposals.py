"""Traffic `bop_proposals`: a closed loop of BOP test images through
FreePose's first static stage, scripts/extract_proposals_ground.py's own
per-image function (`propose_image`), one image after another.

Per image (all of it in the window, as users pay it per image):
GroundingDINO-B at 800² with the prompt "objects." (`forward_images`), the
detector's host selection at a threshold midway between the image's k-th and
(k+1)-th query scores (k drawn from the seed in 4..12: a random detector
scores whole images alike, so one fixed threshold would keep none or
hundreds), SAM2 Hiera-L's masks of every box as one prompt set (each OR-ed
with its box's pixels, as the coupled cell ORs SAM2's mask with the
object's pixels: a random SAM2 segments nothing in particular, and masks
under 400 pixels dropped a seed-dependent share of the boxes), the
400-pixel filter, DINOv2-L FFA retrieval over the 46,000-row bank (top-100) and the
proposal entries with RLE masks. The window counts the images whose entries
are on the host when it ends.

Set-up: the models with the benchmark's seeded weights, the bank, the
scene's meshes and images, and three images at k = 4, 8 and 12 through the
whole path, which warms every kernel and shape the window uses (retrieval's
padded crop batches of 4, 8 and 16).

The comparison (benchmark/reference/bop_check.py) judges one finished image
drawn from the seed among the first few, whose detector internals (encoder
output, selected positions, last decoder layer) the cell catches on the way
with forward hooks, without a copy or a sync."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import bop, configs_build, flops, flops_gdino, program_spans, synth, weights
from benchmark.reference import models as ref_models
from benchmark.spans import Spans, device_events, summarize

CHECK_POOL = 3  # the first images of the window whose internals are kept for the check


def or_box_pixels(masks: np.ndarray, boxes) -> np.ndarray:
    """Each mask OR-ed with its box's pixels, the detector's hypothesis of
    the object: a random SAM2 segments nothing in particular, and its masks
    of 400 pixels or fewer dropped a seed-dependent share of an image's
    boxes (0-45% of a seed's), and with them of its work."""
    out = masks.copy()
    h, w = out.shape[1:]
    for i, box in enumerate(np.asarray(boxes, np.float64)):
        xa, xb = int(np.clip(np.floor(box[0]), 0, w)), int(np.clip(np.ceil(box[2]), 0, w))
        ya, yb = int(np.clip(np.floor(box[1]), 0, h)), int(np.clip(np.ceil(box[3]), 0, h))
        out[i, ya:yb, xa:xb] = True
    return out


class BopCell:
    """Set-up, the per-image path and the traced profile both BOP cells
    share; `bop_new_meshes` adds the poses."""

    exact_k = False  # queries tied with the k-th score: dropped (bop.threshold_between), else k kept (bop.first_k)

    def __init__(self, cfg: dict, workload: dict, seed: int, device, trace: bool):
        from freepose_tpu_torch.models import grounding_dino
        from freepose_tpu_torch.scripts import dino_inference, extract_proposals_ground

        if not (hasattr(extract_proposals_ground, "propose_image") and hasattr(dino_inference, "pose_frame")
                and hasattr(grounding_dino.GroundingDinoDetector, "select_boxes")
                and hasattr(grounding_dino, "QuerySelect")):
            raise RuntimeError("bop cells: this program's static CLIs have no per-image functions "
                               "(extract_proposals_ground.propose_image, dino_inference.pose_frame) or its detector "
                               "no host selection (GroundingDinoDetector.select_boxes) or no selection module "
                               "(QuerySelect), which the cells call and hook; "
                               "they cannot run on it")
        from freepose_tpu_torch.models.dinov2 import DinoFeatureExtractor
        from freepose_tpu_torch.models.grounding_dino import GroundingDinoDetector
        from freepose_tpu_torch.models.sam2.predictor import Sam2ImagePredictor

        self.cfg, self.params, self.seed, self.dev, self.trace = cfg, workload["params"], seed, device, trace
        on_card = torch.device(device).type == "cuda"
        served = configs_build.served_dtype(cfg)
        run_dtype = served if on_card else torch.float32
        g, sc, ret = cfg["grounding_dino"], cfg["scene"], cfg["retrieval"]

        pcfg = bop.port_gdino_config(cfg, run_dtype)
        self.detector = GroundingDinoDetector(pcfg, image_size=g["image_size"], device=device)
        self.gd_weights = bop.gdino_weights(cfg, seed, device, served)
        weights.load_into(self.detector.model, bop.port_state(self.gd_weights, pcfg.decoder_layers))
        self.predictor = Sam2ImagePredictor(configs_build.sam2_image_config(cfg, configs_build.PORT, run_dtype,
                                                                            on_card),
                                            image_size=cfg["sam2"]["image_size"], device=device)
        weights.load_into(self.predictor.model, weights.make_weights(
            bop.spec_sam2_image(cfg), synth.sub_seed(seed, "sam2_image"), device, served))
        self.vit_l = DinoFeatureExtractor(configs_build.dinov2_config(cfg, "dinov2_l", configs_build.PORT,
                                                                      run_dtype), device=device)
        weights.load_into(self.vit_l.model, weights.make_weights(ref_models.spec_dinov2(cfg, "dinov2_l"),
                                                                 synth.sub_seed(seed, "dinov2_l"), device, served))
        gc.collect()

        self.bank = bop.make_bank(seed, ret["bank_rows"], ret["bank_dim"], device)
        self.names = [f"obj{row:05d}" for row in range(ret["bank_rows"])]
        self.meshes = bop.scene_meshes(seed, sc["meshes"], cfg["mesh"]["n_u"], cfg["mesh"]["n_v"])
        images = bop.make_images(seed, self.meshes, self.params["images"], (sc["height"], sc["width"]),
                                 sc["objects"], sc["object_res"], device)
        fx, fy, cx, cy = sc["intrinsics"]
        self.k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.entries = [{"image": im["image"], "scene_id": 0, "frame_id": i, "intrinsic": self.k}
                        for i, im in enumerate(images)]
        self.k_rng = np.random.default_rng(synth.sub_seed(seed, "k"))
        self._install_capture()
        self._setup_extra()
        self.done: list[dict] = []
        self.warming = True
        for i, k in enumerate(self._warm_ks()):
            self._image(i, k=k, capture=False)
        self.warming = False
        self._after_warm()
        self._sync()

    # ------------------------------------------------------------ set-up hooks
    def _setup_extra(self) -> None:
        pass

    def _after_warm(self) -> None:
        pass

    def _warm_ks(self):
        """The largest k of each padded retrieval batch (a power of two) the
        draws can give."""
        p = self.params
        pads = {}
        for k in range(p["k_min"], p["k_max"] + 1):
            pads[1 << (k - 1).bit_length()] = k
        return tuple(sorted(pads.values()))

    def _next_k(self) -> int:
        p = self.params
        return int(self.k_rng.integers(p["k_min"], p["k_max"] + 1))

    def _sync(self) -> None:
        if torch.device(self.dev).type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _install_capture(self) -> None:
        """Forward hooks that keep, for an image being captured, the
        detector's encoder output, its selected positions and its last
        decoder layer's output (references; nothing synchronises). Where the
        program replays the forward as CUDA graphs the hooks run only while
        a graph is captured: they keep the graph's static tensors then, and
        a captured image takes copies of them after its replay."""
        model = self.detector.model
        self.cap, self.static = None, {}

        def keep(key, value):
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                self.static[key] = value
            elif self.cap is not None:
                self.cap[key] = value

        def hook(key, part=0):
            return lambda _module, _inputs, output: keep(key, output[part] if isinstance(output, tuple) else output)

        model.get_submodule(f"enc{model.config.encoder_layers - 1}").register_forward_hook(hook("memory"))
        model.get_submodule(f"dec{model.config.decoder_layers - 1}").register_forward_hook(hook("hidden"))
        model.query_select.register_forward_hook(hook("select", 1))

    def _from_replay(self, cap: dict) -> None:
        """A captured image whose forward replayed: copies of the static
        tensors its replay wrote."""
        for key in ("memory", "hidden", "select"):
            if key not in cap:
                cap[key] = self.static[key].clone()

    def reset_graphs(self) -> None:
        """Drop the program's detector graphs (a fault planted or lifted
        must be captured anew); a program without them has nothing to drop."""
        graphs = getattr(self.detector, "_graphs", None)
        if graphs is not None:
            graphs.clear()

    # ------------------------------------------------------------ the path
    def _propose(self, i: int, k: int, cap: dict | None) -> list[dict]:
        """Image i through extract_proposals_ground.propose_image."""
        from freepose_tpu_torch.scripts.extract_proposals_ground import propose_image, sam2_masks

        entry = self.entries[i % len(self.entries)]
        det, g, ret = self.detector, self.cfg["grounding_dino"], self.cfg["retrieval"]

        def threshold(scores):
            thr = bop.threshold_between(scores, k, keep_ties=self.exact_k)
            if cap is not None:
                cap["thr"] = thr
            return thr

        def detect(e):
            logits, boxes = det.forward_images([e["image"]], text=g["prompt"])
            if cap is not None:
                cap.update(logits=logits, boxes=boxes)
                self._from_replay(cap)
            (xyxy, scores), = det.select_boxes(logits, boxes, [e["image"].shape[:2]], threshold)
            if self.exact_k:
                first = bop.first_k(scores, k)
                xyxy, scores = xyxy[first], scores[first]
            return xyxy, scores, None

        def segment(image, boxes):
            masks = sam2_masks(self.predictor, image, boxes)
            if cap is not None:
                cap["sam2_masks"] = masks
            return or_box_pixels(masks, boxes)

        self.cap = cap
        try:
            tel = {} if cap is not None else None
            out = propose_image(entry, detect, segment, self.vit_l, self.bank, self.names,
                                layer=ret["feature_layer"], feature_type=ret["feature_type"],
                                min_mask_px=ret["min_mask_px"], telemetry=tel)
        finally:
            self.cap = None
        if cap is not None:
            cap["tel"] = tel
        return out

    def _image(self, i: int, k: int | None = None, capture: bool = False) -> dict:
        """One image's work -> its record (host results; the captured
        internals where `capture`)."""
        k = self._next_k() if k is None else k
        cap = {} if capture else None
        props = self._propose(i, k, cap)
        return {"index": i, "entry": i % len(self.entries), "k": k, "proposals": props, "cap": cap,
                "kept": len(props)}

    # ------------------------------------------------------------ the window
    def window(self, seconds: float) -> dict:
        """The closed loop for `seconds`: a traced window first profiles one
        image, then runs `seconds` more untraced, which mfu.bop reads."""
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        t0 = time.perf_counter()
        i, self.profile, self.profiled = 0, None, None
        if self.trace and torch.device(self.dev).type == "cuda":
            while i < 2 and (self.profile is None or not self.profile["launches"]):
                rec = self._profiled(i, profile, ProfilerActivity)
                rec["end_s"] = time.perf_counter() - t0
                self.done.append(rec)
                i += 1
        self.untraced_start = time.perf_counter() - t0
        deadline = t0 + self.untraced_start + seconds
        while True:
            pooled = sum(rec["cap"] is not None for rec in self.done)
            rec = self._image(i, capture=pooled < CHECK_POOL)
            rec["end_s"] = time.perf_counter() - t0
            rec["in_window"] = rec["end_s"] <= self.untraced_start + seconds or self._counts_last()
            self.done.append(rec)
            i += 1
            if time.perf_counter() >= deadline:
                break
        self._sync()
        self.window_s = time.perf_counter() - t0
        untraced = [rec for rec in self.done if rec.get("in_window")]
        span = self._rate_seconds(seconds)
        out = {"metrics": {"video_frames_per_s": len(untraced) / span}, "attempted": len(self.done), "failed": 0,
               "images": len(untraced), "window_s": self.window_s,
               "proposals_per_image": float(np.mean([rec["kept"] for rec in self.done])),
               "boxes_per_image": float(np.mean([rec["k"] for rec in self.done]))}
        if self.profile is not None:  # the profiled image's split: wall, busy, device and host seconds by layer
            p = self.profile
            out["profiled_s"] = dict(p["program_s"], busy=p["busy_s"], gdino_device=p["gdino_device_s"],
                                     deform_device=p["deform_device_s"])
        return out

    def _counts_last(self) -> bool:
        """The proposals cell counts only images done when the window ends."""
        return False

    def _rate_seconds(self, seconds: float) -> float:
        return seconds

    def _profiled(self, i: int, profile, activity) -> dict:
        """One image under torch.profiler (CPU and CUDA activity, so the
        program's tracer is on and each kernel's launch is in the trace)."""
        from benchmark.traffic.video_smooth import kernels_in_spans
        from freepose_tpu_torch.utils import timing

        timing.reset()
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            self._sync()
            t0 = time.perf_counter()
            rec = self._image(i)
            self._sync()
            t1 = time.perf_counter()
        self.profiled = rec
        records, counts = list(timing.records), dict(timing.counts)
        try:
            gd_s, offset_ns = kernels_in_spans(prof, records, lambda n: n.startswith("gdino."))
            deform_s, _ = kernels_in_spans(prof, records, lambda n: n == "gdino.deform")
        except Exception:  # a trace this torch build lays out otherwise: the metrics are left out
            gd_s = deform_s = offset_ns = None
        spans = Spans(False)
        spans.records = [(n, a * 1e-9, b * 1e-9) for n, parent, a, b in sorted(records, key=lambda r: r[2])
                         if parent is None]
        names = {r[0] for r in records}
        events = [e for e in device_events(prof) if e[0] not in names]
        self.profile = summarize(events, (t0, t1), spans, (offset_ns or 0) * 1e-9)
        self.profile.update(frames=1, counts=counts, gdino_device_s=gd_s, deform_device_s=deform_s,
                            program_s={"image": t1 - t0})
        for name, a, b, around in program_spans.nested(records):
            if not around:
                key = name.split(".")[0]
                self.profile["program_s"][key] = self.profile["program_s"].get(key, 0.0) + (b - a) * 1e-9
        return rec

    # ------------------------------------------------------------ per-layer data
    def _flops(self, rec: dict) -> float:
        """An image's operations: the detector's forward, SAM2's trunk, neck
        and one mask decode per box, DINOv2-L on the padded retrieval crops."""
        cfg, ret = self.cfg, self.cfg["retrieval"]
        boxes = rec["k"]
        vit = flops.vit_image(cfg["dinov2_l"], ret["crop"], ret["feature_layer"])["total"]
        crops = (1 << max(rec["kept"] - 1, 0).bit_length()) if rec["kept"] else 0
        sam2 = flops.hiera(cfg["sam2"])["total"] + flops.neck(cfg["sam2"]) + boxes * flops.mask_decoder(cfg["sam2"])
        return flops_gdino.image_ops(cfg) + sam2 + crops * vit

    def layer_data(self) -> dict:
        prof = self.profile
        after = [rec for rec in self.done if self.profiled is not None and rec["index"] > self.profiled["index"]]
        data = {"profile": prof,
                "untraced": {"flops": sum(self._flops(rec) for rec in after),
                             "seconds": self.window_s - self.untraced_start if after else 0.0}}
        if prof is not None:
            c = prof["counts"]
            work = flops_gdino.work(self.cfg, c.get("gdino.images", 0), c.get("gdino.tokens", 0),
                                    c.get("gdino.queries", 0), c.get("gdino.deform_samples.encoder", 0),
                                    c.get("gdino.deform_samples.decoder", 0))
            if prof.get("gdino_device_s"):
                data["gdino"] = {"work": work["total"], "device_s": prof["gdino_device_s"]}
            if prof.get("deform_device_s"):
                data["gdino_deform"] = {"work": work["deform"], "device_s": prof["deform_device_s"]}
        return data

    # ------------------------------------------------------------ correctness
    def _checked(self) -> dict | None:
        pool = [rec for rec in self.done if rec["cap"] is not None and rec["cap"].get("tel", {}).get("keep")]
        if not pool:
            return None
        rng = np.random.default_rng(synth.sub_seed(self.seed, "check"))
        return pool[int(rng.integers(len(pool)))]

    def check(self, control: bool = False) -> dict:
        """Judges one captured image (benchmark/reference/bop_check.py)."""
        from benchmark.reference import bop_check

        rec = self._checked()
        if rec is None:
            return {"error": "no captured image kept a proposal"}
        self._sync()
        return bop_check.judge(self.cfg, self.seed, self.gd_weights, self.entries[rec["entry"]], rec, self.bank,
                               self.meshes, self.dev, control)


class BopProposals(BopCell):
    pass


def setup(cfg: dict, workload: dict, seed: int, device, trace: bool) -> BopProposals:
    return BopProposals(cfg, workload, seed, device, trace)
