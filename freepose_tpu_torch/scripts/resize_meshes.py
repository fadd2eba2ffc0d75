"""Normalize meshes to unit half-extent: AABB-centred, scaled so that the
largest extent is 2, written as OBJ. A mesh that fails to load or write is
reported and the others go on. Runs on the host only.

save_obj writes vertices (with colours) and faces only, so a textured mesh
comes out with its atlas baked into vertex colours, as the JAX package's
script writes it.

Usage: python -m freepose_tpu_torch.scripts.resize_meshes --mesh-dir M --out OUT
"""
from __future__ import annotations

import argparse
from pathlib import Path

from freepose_tpu_torch.io.mesh import load_obj, save_obj


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-dir", required=True, help="dir of <id>/<id>.obj meshes")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out_root = Path(args.out)
    out_root.mkdir(parents=True, exist_ok=True)
    n_ok = n_fail = 0
    for mesh_dir in sorted(Path(args.mesh_dir).iterdir()):
        obj = mesh_dir / f"{mesh_dir.name}.obj"
        if not obj.exists():
            continue
        try:
            mesh = load_obj(obj).normalized()
            out_dir = out_root / mesh_dir.name
            out_dir.mkdir(exist_ok=True)
            save_obj(mesh, out_dir / f"{mesh_dir.name}.obj")
            n_ok += 1
        except (OSError, ValueError, IndexError) as e:
            print(f"failed {mesh_dir.name}: {e}")
            n_fail += 1
    print(f"normalized {n_ok} meshes ({n_fail} failures)")


if __name__ == "__main__":
    main()
