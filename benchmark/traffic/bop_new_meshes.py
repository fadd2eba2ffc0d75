"""Traffic `bop_new_meshes`: a closed loop of BOP test images through both
static stages, extract_proposals_ground's `propose_image` (k = 8, LM-O's
eight objects) and then dino_inference's `pose_frame`, where every
proposal's mesh has no template pack yet. BENCHMARK.json holds no cell of
it yet: its cell `bop.new-meshes` waits for two sets of 6 seeds on a card
(its parameters: images 8, k 8, the proposals cell's limits and the pose
numbers', crop_err 0.01, pack_feat_err 0.03, pose_off_grid 0, pose_gap
0.02, score_err 0.03, lift_err 0.01).

Per image: the proposals as `bop_proposals` makes them, with exactly 8
boxes: the threshold lies between the 8th and the next smaller distinct
score, and of the queries it keeps those of the 8 best scores go on, a tie
at the 8th broken by query index (bop.first_k), so that a seed's work per
image does not follow the ties of its bf16 scores; each proposal's pack
named by its retrieved row, the image and the proposal (random features can
retrieve one row for several proposals), so that `TemplateBank.get(name,
mesh)` builds every pack in the window: K1 renders the row's mesh from 600
views, DINOv2-L featurizes them in batches of 128, then the depth
statistics; the bank's cache of 8 holds the image's packs. Then the coarse
pose of every proposal (`CoarsePoseEstimator.estimate_batch`) and its BOP
row. The window runs to the end of the image during which it ends.

Set-up as `bop_proposals`, with two images, each image's first two
proposals through `pose_frame`, which builds their packs and warms their
kernels; the cache is emptied before the window opens."""
from __future__ import annotations

import numpy as np

from benchmark import flops, synth
from benchmark.traffic.bop_proposals import BopCell

CHECK_VIEWS = 6  # views of a checked pack compared with the reference's


class BopNewMeshes(BopCell):
    exact_k = True
    def _setup_extra(self) -> None:
        from freepose_tpu_torch.io.mesh import TriMesh
        from freepose_tpu_torch.pipeline.pose_estimator import CoarsePoseEstimator
        from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
        from freepose_tpu_torch.pipeline.template_bank import TemplateBank

        p = self.cfg["pose"]
        self.tri = [TriMesh(*m) for m in self.meshes]
        renderer = TemplateRenderer(n_poses=p["n_coarse_poses"], resolution=p["template_res"], device=self.dev)
        self.tbank = TemplateBank(self._pack_features, renderer, cache_size=p["pack_cache"],
                                  batch_size=p["pack_batch"], device=self.dev)
        self.estimator = CoarsePoseEstimator(self._query_features, self.tbank)
        self.pose_cap = None
        self.views = sorted(np.random.default_rng(synth.sub_seed(self.seed, "check_views")).choice(
            p["n_coarse_poses"], size=min(CHECK_VIEWS, p["n_coarse_poses"]), replace=False).tolist())

    def _warm_ks(self):
        """Two images: the detector's graph is captured on its second."""
        return (self.params["k"],) * 2

    def _next_k(self) -> int:
        return self.params["k"]

    def _after_warm(self) -> None:
        self.tbank.cache.clear()

    def _counts_last(self) -> bool:
        return True

    def _rate_seconds(self, seconds: float) -> float:
        return self.window_s - self.untraced_start

    def _pack_features(self, imgs):
        return self.vit_l(imgs, layer=self.cfg["pose"]["feature_layer"], feature_type="patch")

    def _query_features(self, imgs):
        if self.pose_cap is not None:
            self.pose_cap["query_crops"] = imgs
        return self.vit_l(imgs, layer=self.cfg["pose"]["feature_layer"], feature_type="patch")

    def _get_pack(self, name: str):
        row = int(name.split(".")[0][len("obj"):])
        pack = self.tbank.get(name, self.tri[row % len(self.tri)])
        if self.pose_cap is not None and "pack" not in self.pose_cap:
            self.pose_cap["pack"] = {"name": name, "row": row, "views": self.views,
                                     "feats": pack.feats[self.views].clone()}
        return pack

    def _image(self, i: int, k: int | None = None, capture: bool = False) -> dict:
        from freepose_tpu_torch.scripts.dino_inference import pose_frame

        rec = super()._image(i, k, capture)
        entry = self.entries[rec["entry"]]
        props = [dict(p, mesh=f"{p['mesh']}.i{i}.p{j}") for j, p in enumerate(rec["proposals"])]
        if self.warming:
            props = props[:2]
        rec["poses"], rec["packs"] = [], 0
        if props:
            self.pose_cap = rec["cap"]
            try:
                rec["poses"] = pose_frame(entry, props, self.estimator, self._get_pack, self.dev,
                                          bbox_extend=self.cfg["pose"]["bbox_extend"],
                                          depth_method=self.cfg["pose"]["depth_method"])
            finally:
                self.pose_cap = None
            rec["packs"] = len(props)
        rec["pose_props"] = props
        return rec

    def _flops(self, rec: dict) -> float:
        """The proposals' operations, then DINOv2-L on each pack's views and
        on the query crops (renders take no product and count nothing)."""
        p = self.cfg["pose"]
        vit = flops.vit_image(self.cfg["dinov2_l"], p["template_res"], p["feature_layer"])["total"]
        return super()._flops(rec) + rec["packs"] * (p["n_coarse_poses"] + 1) * vit


def setup(cfg: dict, workload: dict, seed: int, device, trace: bool) -> BopNewMeshes:
    return BopNewMeshes(cfg, workload, seed, device, trace)
