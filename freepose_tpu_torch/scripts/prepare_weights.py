"""Convert every released checkpoint found under --ckpt-dir in one command.

Drop the released checkpoints under --ckpt-dir with the exact file names
below and run

    python -m freepose_tpu_torch.scripts.prepare_weights

Each family found is converted into the .npz of JAX-layout parameters that
the CLIs' --weights flags read (scripts/convert_weights.py, the one-file CLI
this batches over); a missing file is noted and skipped. No forward check
runs here. Runs on the host only.

Expected checkpoint files (all public):

  dinov2_vitl14_reg4_pretrain.pth   torch.hub facebookresearch/dinov2
  dinov2_vitb14_reg4_pretrain.pth   torch.hub facebookresearch/dinov2
  open_clip_pytorch_model.bin       HF laion/CLIP-ViT-bigG-14-laion2B-39B-b160k
  grounding-dino-base.bin           HF IDEA-Research/grounding-dino-base
                                    (pytorch_model.bin, Swin-B backbone)
  sam2-hiera-large.bin              HF facebook/sam2-hiera-large (transformers
                                    Sam2VideoModel state dict)
  zoedepth-nyu.bin                  HF Intel/zoedepth-nyu (pytorch_model.bin)
  cotracker2.pth                    torch.hub facebookresearch/co-tracker
"""
from __future__ import annotations

import argparse
from pathlib import Path

# (file name, output .npz, convert_weights kind, converter arguments)
FAMILIES = [
    ("dinov2_vitl14_reg4_pretrain.pth", "dinov2_vitl.npz", "dinov2-hub", {"layers": 24}),
    ("dinov2_vitb14_reg4_pretrain.pth", "dinov2_vitb.npz", "dinov2-hub", {"layers": 12}),
    ("open_clip_pytorch_model.bin", "clip_bigg.npz", "clip-openclip",
     {"vision_layers": 48, "text_layers": 32}),
    ("grounding-dino-base.bin", "grounding_dino.npz", "grounding-dino-hf",
     {"swin_depths": [2, 2, 18, 2], "text_layers": 12}),
    ("sam2-hiera-large.bin", "sam2_hiera_l.npz", "sam2-video-hf", {"total_blocks": 48}),
    ("zoedepth-nyu.bin", "zoedepth.npz", "zoedepth-hf", {"layers": 24}),
    ("cotracker2.pth", "cotracker2.npz", "cotracker2-hub", {}),
]


def convert_one(ckpt: Path, out: Path, kind: str, kw: dict) -> None:
    from freepose_tpu_torch.models.convert import save_params
    from freepose_tpu_torch.scripts.convert_weights import convert, load_state_dict

    save_params(convert(load_state_dict(str(ckpt)), kind, **kw), out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="data/checkpoints")
    ap.add_argument("--out-dir", default="data/params")
    ap.add_argument("--force", action="store_true", help="reconvert existing outputs")
    args = ap.parse_args(argv)

    ckpt_dir, out_dir = Path(args.ckpt_dir), Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_done = n_skip = 0
    for fname, out_name, kind, kw in FAMILIES:
        src, dst = ckpt_dir / fname, out_dir / out_name
        if not src.exists():
            print(f"MISSING  {src}  (skipping {out_name}; see module docstring "
                  f"for the expected source)")
            n_skip += 1
            continue
        if dst.exists() and not args.force:
            print(f"exists   {dst}  (--force to reconvert)")
            n_done += 1
            continue
        print(f"convert  {src} -> {dst}  [{kind}]", flush=True)
        convert_one(src, dst, kind, kw)
        n_done += 1
    print(f"{n_done} families ready, {n_skip} missing under {ckpt_dir}/")
    if n_skip == 0:
        print(f"all {len(FAMILIES)} families converted")


if __name__ == "__main__":
    main()
