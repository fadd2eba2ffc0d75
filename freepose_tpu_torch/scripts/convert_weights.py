"""Convert released torch checkpoints into the .npz every --weights flag reads.

One CLI for every model family: pass the torch state-dict file (torch.hub,
HF `pytorch_model.bin` or a SAM2 state dict) and the model kind; the matching
converter of freepose_tpu_torch.models.convert (SAM2: models.sam2.convert)
maps it onto the JAX-layout parameter tree, saved as the flat '/'-joined
.npz that both packages' CLIs load. Runs on the host only.

Examples:
  python -m freepose_tpu_torch.scripts.convert_weights --kind dinov2-hub \
      --ckpt dinov2_vitl14_reg.pth --layers 24 --out dinov2_l.npz
  python -m freepose_tpu_torch.scripts.convert_weights --kind sam2-video-hf \
      --ckpt sam2_hf_state.bin --out sam2.npz
"""
from __future__ import annotations

import argparse

from freepose_tpu_torch.models.convert import save_params

KINDS = ("dinov2-hub", "dinov2-hf", "clip-openclip", "clip-hf", "swin-hf", "bert-hf", "grounding-dino-hf",
         "sam2-image-hf", "sam2-video-hf", "zoedepth-hf", "cotracker2-hub")


def load_state_dict(path: str) -> dict:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "module"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return obj


def convert(sd: dict, kind: str, layers: int = 24, text_layers: int = 12, vision_layers: int = 48,
            total_blocks: int = 48, swin_depths=(2, 2, 18, 2)) -> dict:
    """A released state dict of model `kind` -> the JAX-layout tree."""
    from freepose_tpu_torch.models import convert as C
    from freepose_tpu_torch.models.sam2 import convert as S

    if kind == "dinov2-hub":
        return C.dinov2_from_hub(sd, layers)
    if kind == "dinov2-hf":
        return C.dinov2_from_hf(sd, layers)
    if kind == "clip-openclip":
        return C.clip_from_open_clip(sd, vision_layers, text_layers)
    if kind == "clip-hf":
        return C.clip_from_hf(sd, vision_layers, text_layers)
    if kind == "swin-hf":
        return C.swin_from_hf(sd, swin_depths, out_stages=[1, 2, 3])
    if kind == "bert-hf":
        return C.bert_from_hf(sd, layers)
    if kind == "grounding-dino-hf":
        return C.grounding_dino_from_hf(sd, swin_depths=swin_depths, swin_out_stages=[1, 2, 3],
                                        text_layers=text_layers)
    if kind == "zoedepth-hf":
        return C.zoedepth_from_hf(sd, num_layers=layers)
    if kind == "cotracker2-hub":
        return C.cotracker2_from_hub(sd)
    if kind == "sam2-image-hf":
        return S.sam2_image_model_from_hf(sd, total_blocks=total_blocks)
    if kind == "sam2-video-hf":
        return S.sam2_video_model_from_hf(sd, total_blocks=total_blocks)
    raise ValueError(kind)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--layers", type=int, default=24, help="transformer depth")
    ap.add_argument("--text-layers", type=int, default=12)
    ap.add_argument("--vision-layers", type=int, default=48)
    ap.add_argument("--total-blocks", type=int, default=48, help="hiera/swin total blocks")
    ap.add_argument("--swin-depths", type=int, nargs="+", default=[2, 2, 18, 2],
                    help="Swin stage depths; default = grounding-dino-base "
                         "(Swin-B). Pass 2 2 6 2 for a Swin-T checkpoint.")
    args = ap.parse_args(argv)

    params = convert(load_state_dict(args.ckpt), args.kind, layers=args.layers, text_layers=args.text_layers,
                     vision_layers=args.vision_layers, total_blocks=args.total_blocks, swin_depths=args.swin_depths)
    save_params(params, args.out)
    print(f"{args.kind}: {args.ckpt} -> {args.out}")


if __name__ == "__main__":
    main()
