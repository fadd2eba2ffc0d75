"""BOP-format dataset reader.

Counterpart of the reference's BOPDatasetBase/BOPDataset
(src/dataloader/base_bop.py:11-106, bop.py:19-65): scans scene directories,
caches frame metadata as JSON, and yields per-frame dicts with RGB, sensor
depth (BOP 0.1mm units -> metres), predicted depth, visible masks, boxes and
intrinsics. Pure host-side IO — batching/prefetch to device is the caller's
job.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _imread(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


class BOPDataset:
    def __init__(self, root_dir: str | Path, split: str, use_visible_masks: bool = True):
        root = Path(root_dir)
        if not root.is_absolute() and not root.exists():
            # Bare dataset names resolve under $BOP_PATH (reference
            # bop_toolkit_lib/config.py:12-15 convention).
            import os

            bop_path = os.environ.get("BOP_PATH")
            if bop_path and (Path(bop_path) / root).exists():
                root = Path(bop_path) / root
        root = root.resolve()
        name = root.name
        if "tless" in name or "hb" in name:
            split = f"{split}_primesense"
        self.path = root
        self.split = split
        self.use_visible_masks = use_visible_masks
        self.split_dir = root / split
        cache = root / f"{split}_metadata.json"
        if cache.exists():
            self.frames = json.loads(cache.read_text())
        else:
            self.frames = self._scan()
            try:
                cache.write_text(json.dumps(self.frames))
            except OSError:
                pass

    def _scan(self) -> list[dict]:
        frames = []
        for scene_path in sorted(self.split_dir.iterdir()):
            if not scene_path.is_dir():
                continue
            cam = json.loads((scene_path / "scene_camera.json").read_text())
            gt_path = scene_path / "scene_gt.json"
            gt = json.loads(gt_path.read_text()) if gt_path.exists() else {}
            info_path = scene_path / "scene_gt_info.json"
            gt_info = json.loads(info_path.read_text()) if info_path.exists() else {}
            rgb_paths = sorted((scene_path / "rgb").glob("*.*")) if (scene_path / "rgb").exists() else []
            for rgb_path in rgb_paths:
                fid = int(rgb_path.stem)
                entry = {
                    "scene_id": int(scene_path.name),
                    "frame_id": fid,
                    "rgb_path": str(rgb_path),
                    "depth_path": str(scene_path / "depth" / rgb_path.name),
                    "depth_pred_path": str(scene_path / "depth_pred" / rgb_path.name),
                    "intrinsic": cam[str(fid)]["cam_K"],
                    "obj_ids": [int(e["obj_id"]) for e in gt.get(str(fid), [])],
                    "gt": gt.get(str(fid), []),
                    # Per-GT visibility info (scene_gt_info.json) — used by
                    # the eval protocol's "inst_count most visible" validity
                    # rule (reference eval_calc_scores.py:238-253).
                    "gt_info": gt_info.get(str(fid), []),
                    "mask_visib": sorted(
                        str(p) for p in scene_path.glob(f"mask_visib/{fid:06d}_*.*")
                    ),
                    "mask": sorted(str(p) for p in scene_path.glob(f"mask/{fid:06d}_*.*")),
                }
                frames.append(entry)
        return frames

    def __len__(self) -> int:
        return len(self.frames)

    def scene_ids(self) -> list[int]:
        return sorted({f["scene_id"] for f in self.frames})

    def __getitem__(self, idx: int) -> dict:
        meta = self.frames[idx]
        image = _imread(Path(meta["rgb_path"]))
        if image.ndim == 2:
            image = np.stack([image] * 3, -1)
        image = image[..., :3]

        depth = None
        if Path(meta["depth_path"]).exists():
            depth = _imread(Path(meta["depth_path"])).astype(np.float32) * 0.1 / 1000.0
        depth_pred = None
        if Path(meta["depth_pred_path"]).exists():
            depth_pred = _imread(Path(meta["depth_pred_path"])).astype(np.float32) / (2**16 - 1)

        mask_paths = meta["mask_visib"] if self.use_visible_masks else meta["mask"]
        masks, boxes = [], []
        for mp in mask_paths:
            m = _imread(Path(mp)) > 0
            ys, xs = np.nonzero(m)
            if len(ys) == 0:
                continue
            masks.append(m)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        return {
            "image": image,
            "depth": depth,
            "depth_pred": depth_pred,
            "scene_id": meta["scene_id"],
            "frame_id": meta["frame_id"],
            "masks": np.stack(masks) if masks else np.zeros((0,) + image.shape[:2], bool),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "intrinsic": np.asarray(meta["intrinsic"], np.float64).reshape(3, 3),
            "gt": meta["gt"],
            "gt_info": meta.get("gt_info", []),
        }
