"""Per-mesh, per-view retrieval features from template shards.

Counterpart of the JAX package's scripts/extract_retrieval_features.py, with
the same arguments (plus --device) and the same files: for each mesh, the
rendered views cropped to their masks at 420², DINOv2 features at --layer
(on the card DINOv2-L in bf16, every attention call on kernel K2 at d 64),
FFA pooling of the patch tokens over the 30x30 mask grid (or the normalised
cls token), in batches of --batch-size; one [V, D] .npy per mesh (V = 600
views). merge_features then averages them into the retrieval bank.

Usage: python -m freepose_tpu_torch.scripts.extract_retrieval_features \
         --wds-dir SHARDS --filelist meshes.txt --out FEATS [--weights dinov2.npz] \
         [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.template import Prefetcher, WebTemplateDataset
from freepose_tpu_torch.geometry.boxes import mask_to_bbox
from freepose_tpu_torch.geometry.crop import crop_resize_pad
from freepose_tpu_torch.ops.sampling import ffa_pool
from freepose_tpu_torch.pipeline.template_bank import normalize_feats
from freepose_tpu_torch.scripts.common import (
    add_device_arg,
    add_shard_args,
    get_shard,
    load_dino_extractor,
    load_filelist,
)


def view_features(extractor, rgb: np.ndarray, masks: np.ndarray, layer: int, feature_type: str,
                  batch_size: int) -> np.ndarray:
    """Views [V, H, W, 3] in [0, 1] with masks [V, H, W] -> [V, D] fp32:
    each view cropped to its mask's box at 420², then FFA-pooled patch
    features (or the normalised cls token) in batches of `batch_size`."""
    dev = extractor.device
    rgb = torch.as_tensor(rgb, device=dev).permute(0, 3, 1, 2)
    masks = torch.as_tensor(masks, device=dev)
    boxes = mask_to_bbox(masks)
    crops = crop_resize_pad(rgb, boxes, 420)
    mask_crops = crop_resize_pad(masks[:, None].float(), boxes, 420)[:, 0] > 0.5
    feats = []
    for i in range(0, crops.shape[0], batch_size):
        batch = crops[i : i + batch_size]
        if feature_type == "cls":
            f = normalize_feats(extractor(batch, layer=layer, feature_type="cls").float())
        else:
            patch = extractor(batch, layer=layer, feature_type="patch")
            f = ffa_pool(patch.float(), mask_crops[i : i + batch_size], grid=30)
        feats.append(f.cpu().numpy().astype(np.float32))
    return np.concatenate(feats)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wds-dir", required=True)
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None, help="converted DINOv2 params (.npz)")
    ap.add_argument("--layer", type=int, default=22)
    ap.add_argument("--feature-type", choices=["ffa", "cls"], default="ffa")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--meshes-per-task", type=int, default=100)
    add_shard_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    names = load_filelist(args.filelist)
    ds = WebTemplateDataset(args.wds_dir, names)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    extractor = load_dino_extractor(args.weights, device=args.device)
    shard = get_shard(args)
    indices = shard.slice(len(ds), chunk=args.meshes_per_task) if args.shard_count else shard.slice(len(ds))

    for item in Prefetcher(ds, indices):
        name = item["model_name"]
        out_path = out_dir / f"{name}.npy"
        if out_path.exists():
            continue
        np.save(out_path, view_features(extractor, item["rgb"], item["masks"], args.layer, args.feature_type,
                                        args.batch_size))
        print(f"features {name}: {out_path}")


if __name__ == "__main__":
    main()
