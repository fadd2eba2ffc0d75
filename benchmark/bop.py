"""What the BOP cells share: GroundingDINO-B's configuration and seeded
weights for the program and the reference, the seeded scene (meshes,
images, retrieval bank), and the host records both traffics keep.

Weights are drawn once per run for the reference's GroundingDINO (the
spec, benchmark/weights.py's rules) and loaded by name into both models;
the program keeps the shared decoder box head as six copies
(`dec_bbox{i}`), each loaded with it. Two scales are then set, as the
configuration's `assumed` says: the fusion's per-channel layer scales 1 +
N(0, 0.02), so that the fusion moves the encoder's output above bf16
rounding (the weights' rule would make them 0.02·N(0, 1)), and the scales of
the two norms whose outputs meet the text in the contrastive logits
(enc_output_norm, decoder_ln) divided by sqrt(d_model), so that a random
detector's logits are O(1) and its scores do not all saturate at 1."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark import synth, weights
from benchmark.reference import grounding_dino as ref_gd

FUSION_SCALE_STD = 0.02


def port_gdino_config(cfg: dict, dtype: torch.dtype):
    """The program's GroundingDinoConfig for the configuration file's
    "grounding_dino" group, every part at `dtype`."""
    from freepose_tpu_torch.models import bert, grounding_dino, swin

    g = cfg["grounding_dino"]

    def fields(cls, values):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: tuple(v) if isinstance(v, list) else v for k, v in values.items() if k in names}

    return grounding_dino.GroundingDinoConfig(
        swin=swin.SwinConfig(**fields(swin.SwinConfig, g["swin"]), dtype=dtype),
        text=bert.BertConfig(**fields(bert.BertConfig, g["text"]), dtype=dtype),
        **fields(grounding_dino.GroundingDinoConfig, g["transformer"]), dtype=dtype)


def gdino_spec(cfg: dict) -> ref_gd.GroundingDino:
    with torch.device("meta"):
        return ref_gd.GroundingDino(ref_gd.config_from(cfg["grounding_dino"]))


def gdino_weights(cfg: dict, seed: int, device, served: torch.dtype) -> dict[str, torch.Tensor]:
    """{reference name: fp32 tensor}: the seeded weights of both sides."""
    spec = gdino_spec(cfg)
    w = weights.make_weights(spec, synth.sub_seed(seed, "grounding_dino"), device, served)
    gen = torch.Generator(device=device).manual_seed(synth.sub_seed(seed, "gdino_scales") % (2**62))
    for name in sorted(w):
        if name.endswith(("fusion_vision_scale", "fusion_text_scale")):
            z = torch.randn(w[name].shape, generator=gen, device=device)
            w[name] = (1.0 + FUSION_SCALE_STD * z).to(served).float()
    d = spec.c.d_model
    for name in ("enc_output_norm.weight", "decoder_ln.weight"):
        w[name] = (w[name] / math.sqrt(d)).to(served).float()
    return w


def port_state(w: dict[str, torch.Tensor], decoder_layers: int) -> dict[str, torch.Tensor]:
    """The reference's names -> the program's: `dec_bbox.*` to each of
    `dec_bbox{i}.*`."""
    out = {}
    for name, t in w.items():
        if name.startswith("dec_bbox."):
            for i in range(decoder_layers):
                out[f"dec_bbox{i}." + name[len("dec_bbox."):]] = t
        else:
            out[name] = t
    return out


def spec_sam2_image(cfg: dict):
    """The SAM2 image model of `cfg` on the meta device: its weights' spec."""
    from benchmark import configs_build
    from benchmark.reference.frozen.sam2.model import Sam2ImageModel

    with torch.device("meta"):
        return Sam2ImageModel(configs_build.sam2_image_config(cfg, configs_build.FROZEN, torch.float32, False))


def reference_gdino(cfg: dict, w: dict[str, torch.Tensor], device) -> ref_gd.GroundingDino:
    model = ref_gd.GroundingDino(ref_gd.config_from(cfg["grounding_dino"])).to(device).eval()
    weights.load_into(model, w)
    return model


# ------------------------------------------------------------------ the scene
def scene_meshes(seed: int, n: int, n_u: int, n_v: int) -> list:
    """`n` seeded coloured tori (synth.bumpy_torus), numpy."""
    return [synth.bumpy_torus(synth.sub_seed(seed, f"scene_mesh{i}"), n_u, n_v) for i in range(n)]


def make_images(seed: int, meshes: list, n_images: int, hw: tuple[int, int], objects: int, object_res: int,
                device) -> list[dict]:
    """`n_images` seeded BOP-like test images of hw = (H, W): noise over
    low-frequency blocks, `objects` sprites of the scene's meshes at seeded
    poses and places. -> [{"image" [H, W, 3] uint8 numpy}]."""
    h, w = hw
    rng = np.random.default_rng(synth.sub_seed(seed, "bop_images"))
    gen = torch.Generator(device=device).manual_seed(synth.sub_seed(seed, "bop_noise") % (2**62))
    out = []
    for _ in range(n_images):
        blocks = torch.rand((3, 6, 8), generator=gen, device=device) * 120
        img = torch.nn.functional.interpolate(blocks[None], size=(h, w), mode="nearest")[0].permute(1, 2, 0)
        img = img + torch.rand((h, w, 3), generator=gen, device=device) * 30
        for _ in range(objects):
            mesh = meshes[int(rng.integers(len(meshes)))]
            q = rng.normal(size=4)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = _quat(q / np.linalg.norm(q))
            pose[2, 3] = synth.RENDER_Z
            rgb, mask = synth.render_sprites(mesh, pose[None], object_res, device)
            y, x = int(rng.integers(0, h - object_res)), int(rng.integers(0, w - object_res))
            patch = img[y:y + object_res, x:x + object_res]
            img[y:y + object_res, x:x + object_res] = torch.where(mask[0][..., None], rgb[0] * 255, patch)
        out.append({"image": img.clamp(0, 255).to(torch.uint8).cpu().numpy()})
    return out


def _quat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]], np.float32)


def make_bank(seed: int, rows: int, dim: int, device) -> torch.Tensor:
    """[rows, dim] seeded unit rows on the device: the retrieval bank."""
    gen = torch.Generator(device=device).manual_seed(synth.sub_seed(seed, "bank") % (2**62))
    bank = torch.randn((rows, dim), generator=gen, device=device)
    return bank / torch.linalg.norm(bank, dim=-1, keepdim=True)


def threshold_between(scores: np.ndarray, k: int, keep_ties: bool = False) -> float:
    """The midpoint of the k-th and (k+1)-th largest of `scores` (bf16
    logits tie often: where the two are equal, every score tied with them
    falls at or under it and is dropped). With `keep_ties`, the midpoint of
    the k-th and the next smaller distinct score instead, which keeps k or
    more (first_k then keeps k of them)."""
    s = np.sort(np.asarray(scores, np.float64))[::-1]
    if not keep_ties:
        return float((s[k - 1] + s[k]) / 2)
    below = s[s < s[k - 1]]
    return float((s[k - 1] + below[0]) / 2) if len(below) else float(s[k - 1]) - 1.0


def first_k(scores: np.ndarray, k: int) -> np.ndarray:
    """The positions of the k largest of `scores`, ties to the lowest
    position, in ascending order: of the queries a threshold kept (in query
    order), those of the k best scores, the tie at the k-th broken by query
    index."""
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    return np.sort(order[:k])
