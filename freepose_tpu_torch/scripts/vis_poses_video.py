"""Overlay a video's estimated 6D poses on its frames.

Counterpart of the JAX package's scripts/vis_poses_video.py, whose flags it
takes, plus --device: every row of the pose CSV is rendered in one
`rasterize` call at --render-size² with the video intrinsics scaled to it
(tile 32, 256 faces per tile: kernel K1 on the card), each render is resized
to the frame and alpha-blended over it, the silhouette is outlined in green,
and one JPEG is written per row, named by its frame.

    python -m freepose_tpu_torch.scripts.vis_poses_video --video-dir FRAMES \
        --poses track.csv --mesh-dir meshes --out-dir OUT [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from freepose_tpu_torch.datasets.video import load_frame_dir
from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.geometry.camera import default_video_intrinsics
from freepose_tpu_torch.io.bop_csv import read_results_csv
from freepose_tpu_torch.io.mesh import load_obj, pad_mesh
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize
from freepose_tpu_torch.ops.sampling import resize_bilinear
from freepose_tpu_torch.scripts.common import add_device_arg


@torch.inference_mode()
def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--poses", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--render-size", type=int, default=480)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    from PIL import Image

    dev = resolve_device(args.device)
    frames = load_frame_dir(args.video_dir)
    h, w = frames.shape[1:3]
    results = sorted(read_results_csv(args.poses, t_scale=1.0), key=lambda r: r.im_id)
    mesh_id = results[0].obj_id
    mesh = load_obj(Path(args.mesh_dir) / str(mesh_id) / f"{mesh_id}.obj").normalized().scaled(results[0].scale)
    v, c, f, valid = (torch.as_tensor(x, device=dev) for x in pad_mesh(mesh, 16384, 32768))

    # A square render at --render-size with the intrinsics scaled to it.
    size = args.render_size
    scale = size / max(h, w)
    k = default_video_intrinsics(w, h).numpy() * np.array([[scale], [scale], [1]])
    settings = RasterSettings(resolution=size, tile=32, max_faces_per_tile=256)
    poses = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in results])
    rgb, depth = rasterize(v, c, f, valid, torch.as_tensor(poses, dtype=torch.float32, device=dev),
                           torch.as_tensor(k, dtype=torch.float32, device=dev), settings)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for r, render, d in zip(results, rgb, depth):
        frame = frames[r.im_id].astype(np.float32) / 255.0
        rend = resize_bilinear(render.permute(2, 0, 1), (h, w)).permute(1, 2, 0).cpu().numpy()
        mask = (resize_bilinear((d > 0).to(torch.float32), (h, w)) > 0.5).cpu().numpy()
        over = frame.copy()
        over[mask] = (1 - args.alpha) * frame[mask] + args.alpha * rend[mask]
        # Outline: the mask's 4-neighbour dilation minus the mask.
        grown = np.zeros_like(mask)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            grown |= np.roll(mask, (dy, dx), axis=(0, 1))
        over[grown & ~mask] = (0.1, 1.0, 0.1)
        Image.fromarray((over * 255).astype(np.uint8)).save(out / f"{r.im_id:06d}.jpg")
    print(f"overlays -> {out}")


if __name__ == "__main__":
    main()
