"""Central pipeline configuration.

The reference scatters its hyperparameters across inline magic constants and
artifact FILENAMES (SURVEY.md §5.6: render scale 0.25 at
online_pose_estimator.py:23, camera z=1.1/f=600/res=420 at renderer.py:33-37,
FFA grid 30×30 at extract_proposals_ground.py:129, fine sampling 20k/15° at
dino_inference_video.py:64,155, interval 12 at smooth_poses_video.py:98,
GT scale 0.15 at eval_videos.py:47). Here every knob is one named field with
its provenance, serializable to/from JSON so runs are reproducible artifacts
rather than encoded filenames.

A copy of freepose_tpu.config (standard library only):
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass
class PipelineConfig:
    # Template rendering (reference renderer.py:33-41, render_templates.py:61)
    template_views: int = 600
    template_resolution: int = 420
    template_focal: float = 600.0
    template_z: float = 1.1
    rendering_scale: float = 0.25

    # Features / retrieval (extract_proposals_ground.py:36,129-140)
    dino_layer: int = 22
    ffa_grid: int = 30
    feature_type: str = "ffa"  # or "cls"
    retrieval_topk: int = 100
    fine_rerank_topk: int = 0  # 0 = coarse only
    bbox_extend_proposals: float = 0.1
    bbox_extend_pose: float = 0.2
    min_mask_px: int = 400

    # Detection (extract_proposals_ground.py thresholds)
    text_prompt: str = "objects."
    box_threshold: float = 0.15
    text_threshold: float = 0.15

    # Scale estimation (scale_estimators.py:36, compute_scale.py)
    scale_query_k: int = 11
    scale_erosion_radius: int = 8
    scale_min_vertices: int = 25
    scale_std_factor: float = 1.5

    # Online refinement (dino_inference_video.py:64,155)
    fine_poses: int = 10000
    fine_neighborhood_deg: float = 15.0
    fine_neighbors_cap: int = 256  # static pad of the geodesic neighbourhood

    # Track refinement (smooth_poses_video.py:98, refiner_utils.py:210-221)
    refine_interval: int = 12
    smooth_t_window: int = 5
    smooth_r_window: int = 9
    refiner_resolution: int = 518
    crop_lambda: float = 1.4

    # Evaluation (eval_videos.py:47,186)
    gt_video_scale: float = 0.15
    drift_dts: int = 10
    sym_samples: int = 101

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "PipelineConfig":
        data = json.loads(Path(path).read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})
