"""Render 600-view template shards for a mesh filelist.

10 meshes per tar shard, 600 super-Fibonacci views at 0.25 render scale,
rgb + depth PNG members (the shard format of the JAX package's
render_templates, which reads these shards as they are), rendered by the
tile rasterizer (kernel K1 on the card).

Usage: python -m freepose_tpu_torch.scripts.render_templates \
         --mesh-dir data/mesh_cache --filelist data/mesh_cache.txt \
         --out data/datasets/objaverse_shards [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from freepose_tpu_torch.datasets.template import MESHES_PER_SHARD, write_shard
from freepose_tpu_torch.io.mesh import load_obj
from freepose_tpu_torch.pipeline.renderer import RENDERING_SCALE, TemplateRenderer
from freepose_tpu_torch.scripts.common import (
    add_device_arg,
    add_shard_args,
    get_shard,
    load_filelist,
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--filelist", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-poses", type=int, default=600)
    ap.add_argument("--resolution", type=int, default=420)
    ap.add_argument("--scale", type=float, default=RENDERING_SCALE)
    add_shard_args(ap)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    names = load_filelist(args.filelist)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    renderer = TemplateRenderer(n_poses=args.n_poses, resolution=args.resolution, device=args.device)

    n_shards = -(-len(names) // MESHES_PER_SHARD)
    shard = get_shard(args)
    for shard_idx in shard.slice(n_shards):
        shard_path = out_dir / f"shard-{shard_idx:06d}.tar"
        if shard_path.exists():
            continue
        chunk = names[shard_idx * MESHES_PER_SHARD : (shard_idx + 1) * MESHES_PER_SHARD]
        payload = {}
        for name in chunk:
            mesh_path = Path(args.mesh_dir) / name / f"{name}.obj"
            try:
                mesh = load_obj(mesh_path).normalized()
            except (OSError, ValueError) as e:
                print(f"skip {name}: {e}")
                continue
            rgb, depth = renderer.render(mesh, scale=args.scale)
            payload[name] = (rgb.cpu().numpy(), depth.cpu().numpy())
            print(f"rendered {name}: {args.n_poses} views")
        write_shard(shard_path, payload)
        print(f"wrote {shard_path}")


if __name__ == "__main__":
    main()
