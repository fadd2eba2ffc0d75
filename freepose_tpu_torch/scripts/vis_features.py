"""DINOv2 patch features as PCA-RGB panels.

Counterpart of the JAX package's scripts/vis_features.py, whose flags it
takes, plus --device: each image is resized to the model square, featurized
once at --layer (DINOv2: kernel K2 at head dim 64 on the card), and written
as `image | PCA(feats) [| mask | PCA(masked feats)]` (utils/viz.py).

    python -m freepose_tpu_torch.scripts.vis_features --images imgs/*.jpg --out feats/ \
        [--weights dinov2_l.npz] [--layer 22] [--masks masks/] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.ops.sampling import resize_bilinear
from freepose_tpu_torch.scripts.common import add_device_arg, load_dino_extractor
from freepose_tpu_torch.utils.viz import feature_panel


@torch.inference_mode()
def main(argv: list[str] | None = None) -> None:
    from PIL import Image

    ap = argparse.ArgumentParser()
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--model", default="vitl", choices=["vitl", "vitb"])
    ap.add_argument("--layer", type=int, default=22)
    ap.add_argument("--masks", default=None, help="dir of per-image binary PNG masks (same stem)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    fe = load_dino_extractor(args.weights, args.model, device=dev)
    size, patch = fe.config.image_size, fe.config.patch_size
    grid = size // patch
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for path in args.images:
        img = torch.as_tensor(np.array(Image.open(path).convert("RGB")), dtype=torch.float32, device=dev)
        square = resize_bilinear(img.permute(2, 0, 1), (size, size))  # [3, S, S]
        feats = fe(square[None] / 255.0, layer=args.layer, feature_type="patch")[0]
        feats = feats.to(torch.float32).reshape(grid, grid, -1)
        mask = None
        if args.masks:
            mpath = Path(args.masks) / (Path(path).stem + ".png")
            if mpath.exists():
                mask = np.asarray(Image.open(mpath).convert("L").resize((grid, grid), Image.NEAREST)) > 127
        panel = feature_panel(square.permute(1, 2, 0).cpu().numpy().astype(np.uint8), feats, mask=mask, patch=patch)
        dst = out / (Path(path).stem + "_feats.png")
        Image.fromarray(panel).save(dst)
        print(f"{path} -> {dst}")


if __name__ == "__main__":
    main()
