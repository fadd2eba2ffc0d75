"""The released-checkpoint converters and the asset and weights CLIs of the
port (convert_weights, prepare_weights, resize_meshes, merge_results) vs the
JAX package's, on the CPU.

State dicts are synthesised as tests/test_convert_fixtures.py does: HF
layouts by instantiating the `transformers` class at the released topology
(depths, registers, stage layouts) and shrunken widths; torch.hub layouts
from their published names. Each converter's tree equals the JAX
converter's bit for bit, and loads strictly into the port's module at the
same topology through the port's `*_from_jax` (where the port's names follow
the JAX tree, its `jax_param_shapes` equal the tree's shapes as well).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import sys

import numpy as np
import pytest
import torch

from freepose_tpu.models import convert as JC
from freepose_tpu.models.sam2 import convert as jax_sam2_convert
from freepose_tpu_torch.models import convert as C
from freepose_tpu_torch.models.sam2 import convert as sam2_convert


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _assert_trees_equal(ours: dict, ref: dict) -> None:
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys(), (sorted(ours.keys() - ref.keys())[:8], sorted(ref.keys() - ours.keys())[:8])
    for path, val in ref.items():
        val = np.asarray(val)
        assert ours[path].dtype == val.dtype == np.float32, path
        np.testing.assert_array_equal(ours[path], val, err_msg=str(path))


def _tensor_factory(seed):
    rng = np.random.default_rng(seed)
    return lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))


# --------------------------------------------------------------------- #
# Synthesised released state dicts and the port modules they load into.

DINO_LAYERS, DINO_HEADS, DINO_WIDTH = 24, 16, 64  # ViT-L/14-reg depth and heads, head_dim 4


def _dinov2_cfg(layers=DINO_LAYERS, heads=DINO_HEADS, width=DINO_WIDTH):
    from freepose_tpu_torch.models.dinov2 import DinoV2Config

    return DinoV2Config(hidden_size=width, num_layers=layers, num_heads=heads, patch_size=14, image_size=56,
                        num_registers=4)


def _dinov2_hf_sd():
    from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel

    torch.manual_seed(0)
    return Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
        hidden_size=DINO_WIDTH, num_hidden_layers=DINO_LAYERS, num_attention_heads=DINO_HEADS,
        intermediate_size=4 * DINO_WIDTH, patch_size=14, image_size=56, num_register_tokens=4)).state_dict()


def dinov2_hub_sd(layers: int, width: int, seed: int = 0) -> dict:
    """torch.hub facebookresearch/dinov2 `dinov2_vit*14_reg` names."""
    t = _tensor_factory(seed)
    sd = {"cls_token": t(1, 1, width), "register_tokens": t(1, 4, width), "pos_embed": t(1, 1 + 16, width),
          "mask_token": t(1, width), "patch_embed.proj.weight": t(width, 3, 14, 14),
          "patch_embed.proj.bias": t(width), "norm.weight": t(width), "norm.bias": t(width)}
    for i in range(layers):
        p = f"blocks.{i}"
        for name, shape in (("norm1", (width,)), ("norm2", (width,))):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = t(*shape), t(*shape)
        for name, (n_out, n_in) in (("attn.qkv", (3 * width, width)), ("attn.proj", (width, width)),
                                    ("mlp.fc1", (4 * width, width)), ("mlp.fc2", (width, 4 * width))):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = t(n_out, n_in), t(n_out)
        sd[f"{p}.ls1.gamma"], sd[f"{p}.ls2.gamma"] = t(width), t(width)
    return sd


def _clip_cfg():
    from freepose_tpu_torch.models.clip import ClipConfig

    return ClipConfig(image_size=28, patch_size=14, vision_width=16, vision_layers=48, vision_heads=2,
                      vocab_size=128, context_length=13, text_width=8, text_layers=32, text_heads=2, embed_dim=8)


def _clip_hf_sd():
    from transformers import CLIPConfig, CLIPModel

    cfg = _clip_cfg()
    torch.manual_seed(0)
    return CLIPModel(CLIPConfig(
        text_config=dict(vocab_size=cfg.vocab_size, hidden_size=cfg.text_width,
                         intermediate_size=cfg.text_width * 4, num_hidden_layers=cfg.text_layers,
                         num_attention_heads=cfg.text_heads, max_position_embeddings=cfg.context_length,
                         projection_dim=cfg.embed_dim),
        vision_config=dict(hidden_size=cfg.vision_width, intermediate_size=cfg.vision_width * 4,
                           num_hidden_layers=cfg.vision_layers, num_attention_heads=cfg.vision_heads,
                           image_size=cfg.image_size, patch_size=cfg.patch_size, projection_dim=cfg.embed_dim),
        projection_dim=cfg.embed_dim)).state_dict()


def _clip_open_clip_sd():
    cfg, t = _clip_cfg(), _tensor_factory(1)
    vw, tw = cfg.vision_width, cfg.text_width
    sd = {"visual.class_embedding": t(vw), "visual.positional_embedding": t(5, vw),
          "visual.conv1.weight": t(vw, 3, 14, 14), "visual.ln_pre.weight": t(vw), "visual.ln_pre.bias": t(vw),
          "visual.ln_post.weight": t(vw), "visual.ln_post.bias": t(vw), "visual.proj": t(vw, cfg.embed_dim),
          "token_embedding.weight": t(cfg.vocab_size, tw), "positional_embedding": t(cfg.context_length, tw),
          "ln_final.weight": t(tw), "ln_final.bias": t(tw), "text_projection": t(tw, cfg.embed_dim),
          "logit_scale": t(), "attn_mask": t(cfg.context_length, cfg.context_length)}
    for prefix, n, w in (("visual.transformer.resblocks", cfg.vision_layers, vw),
                         ("transformer.resblocks", cfg.text_layers, tw)):
        for i in range(n):
            p = f"{prefix}.{i}"
            sd.update({f"{p}.ln_1.weight": t(w), f"{p}.ln_1.bias": t(w), f"{p}.attn.in_proj_weight": t(3 * w, w),
                       f"{p}.attn.in_proj_bias": t(3 * w), f"{p}.attn.out_proj.weight": t(w, w),
                       f"{p}.attn.out_proj.bias": t(w), f"{p}.ln_2.weight": t(w), f"{p}.ln_2.bias": t(w),
                       f"{p}.mlp.c_fc.weight": t(4 * w, w), f"{p}.mlp.c_fc.bias": t(4 * w),
                       f"{p}.mlp.c_proj.weight": t(w, 4 * w), f"{p}.mlp.c_proj.bias": t(w)})
    return sd


SWIN_DEPTHS, SWIN_HEADS = [2, 2, 18, 2], [1, 2, 4, 8]  # grounding-dino-base's Swin-B topology


def _gdino_cfg():
    from freepose_tpu_torch.models.bert import BertConfig
    from freepose_tpu_torch.models.grounding_dino import GroundingDinoConfig
    from freepose_tpu_torch.models.swin import SwinConfig

    return GroundingDinoConfig(
        swin=SwinConfig(embed_dim=8, depths=tuple(SWIN_DEPTHS), num_heads=tuple(SWIN_HEADS), window_size=4,
                        out_stages=(1, 2, 3)),
        text=BertConfig(vocab_size=2000, hidden_size=24, num_layers=12, num_heads=2, intermediate=48,
                        max_position=64),
        d_model=32, num_feature_levels=4, encoder_layers=6, decoder_layers=6, encoder_heads=4, decoder_heads=4,
        encoder_ffn=64, decoder_ffn=64, num_queries=12, max_text_len=16)


@functools.lru_cache(maxsize=None)
def _gdino_hf_sd():
    from transformers import BertConfig, GroundingDinoConfig, GroundingDinoForObjectDetection, SwinConfig

    swin = SwinConfig(image_size=64, patch_size=4, embed_dim=8, depths=SWIN_DEPTHS, num_heads=SWIN_HEADS,
                      window_size=4, out_features=["stage2", "stage3", "stage4"], drop_path_rate=0.0)
    text = BertConfig(vocab_size=2000, hidden_size=24, num_hidden_layers=12, num_attention_heads=2,
                      intermediate_size=48, max_position_embeddings=64)
    cfg = GroundingDinoConfig(backbone_config=swin, text_config=text, d_model=32, num_feature_levels=4,
                              encoder_layers=6, decoder_layers=6, encoder_attention_heads=4,
                              decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=12,
                              max_text_len=16, disable_custom_kernels=True)
    torch.manual_seed(0)
    return GroundingDinoForObjectDetection(cfg).state_dict()


def _zoedepth_cfg():
    from freepose_tpu_torch.models.beit import BeitConfig
    from freepose_tpu_torch.models.zoedepth import DEPTH_TEST

    return dataclasses.replace(
        DEPTH_TEST, beit=BeitConfig(hidden_size=32, num_layers=24, num_heads=4, intermediate_size=64,
                                    patch_size=16, image_size=64, out_indices=(6, 12, 18, 24)),
        neck_hidden_sizes=(16, 24, 32, 40), fusion_hidden_size=32, num_attractors=(16, 8, 4, 1),
        bin_embedding_dim=8, bottleneck_features=32, num_relative_features=8)


def _zoedepth_hf_sd():
    from transformers import ZoeDepthConfig, ZoeDepthForDepthEstimation

    bc = dict(model_type="beit", hidden_size=32, num_hidden_layers=24, num_attention_heads=4, intermediate_size=64,
              image_size=64, patch_size=16, use_relative_position_bias=True,
              out_features=["stage6", "stage12", "stage18", "stage24"], out_indices=[6, 12, 18, 24],
              reshape_hidden_states=False)
    cfg = ZoeDepthConfig(backbone_config=bc, neck_hidden_sizes=[16, 24, 32, 40], fusion_hidden_size=32,
                         num_attractors=[16, 8, 4, 1], bin_embedding_dim=8, bottleneck_features=32,
                         num_relative_features=8)
    torch.manual_seed(0)
    return ZoeDepthForDepthEstimation(cfg).state_dict()


def _cotracker2_cfg():
    from freepose_tpu_torch.models.cotracker2 import COTRACKER2_TEST

    return dataclasses.replace(COTRACKER2_TEST, depth=6)  # the released depth


def cotracker2_hub_sd(seed: int = 0) -> dict:
    """The released `cotracker2` names (the port's CoTracker2 keeps them),
    under the "model." prefix some checkpoints carry."""
    sd = C.cotracker2_from_jax(C.random_cotracker2_params(_cotracker2_cfg(), seed=seed))
    return {f"model.{k}": v for k, v in sd.items()}


def _sam2_cfg():
    from freepose_tpu_torch.models.sam2.hiera import HIERA_L
    from freepose_tpu_torch.models.sam2.model import SAM2_TEST

    # hiera-large's stages, windows and global blocks at a tiny width
    return dataclasses.replace(SAM2_TEST, hiera=dataclasses.replace(HIERA_L, embed_dim=8,
                                                                    embed_dim_per_stage=(8, 16, 32, 64)))


def _sam2_hf_sd():
    from transformers import Sam2Config, Sam2Model
    from transformers.models.sam2.configuration_sam2 import (Sam2HieraDetConfig, Sam2MaskDecoderConfig,
                                                             Sam2PromptEncoderConfig, Sam2VisionConfig)

    h = _sam2_cfg().hiera
    bb = Sam2HieraDetConfig(
        hidden_size=h.embed_dim, num_attention_heads=1, blocks_per_stage=list(h.blocks_per_stage),
        embed_dim_per_stage=list(h.embed_dim_per_stage), num_attention_heads_per_stage=list(h.heads_per_stage),
        window_size_per_stage=list(h.window_size_per_stage), global_attention_blocks=list(h.global_attention_blocks),
        window_positional_embedding_background_size=list(h.window_pos_bg_size), image_size=[64, 64])
    vc = Sam2VisionConfig(backbone_config=bb, backbone_channel_list=[64, 32, 16, 8], fpn_hidden_size=16,
                          backbone_feature_sizes=[[16, 16], [8, 8], [4, 4]], fpn_top_down_levels=[2, 3])
    pe = Sam2PromptEncoderConfig(hidden_size=16, image_size=64, patch_size=16, mask_input_channels=4)
    md = Sam2MaskDecoderConfig(hidden_size=16, num_attention_heads=2, mlp_dim=32, iou_head_hidden_dim=16)
    torch.manual_seed(0)
    return Sam2Model(Sam2Config(vision_config=vc, prompt_encoder_config=pe, mask_decoder_config=md)).state_dict()


def _module(name: str, cfg):
    from freepose_tpu_torch.models.bert import Bert
    from freepose_tpu_torch.models.clip import Clip
    from freepose_tpu_torch.models.cotracker2 import CoTracker2
    from freepose_tpu_torch.models.dinov2 import DinoV2
    from freepose_tpu_torch.models.grounding_dino import GroundingDino
    from freepose_tpu_torch.models.sam2.model import Sam2ImageModel
    from freepose_tpu_torch.models.swin import SwinBackbone
    from freepose_tpu_torch.models.zoedepth import ZoeDepthModel

    cls = {"dinov2": DinoV2, "clip": Clip, "swin": SwinBackbone, "bert": Bert, "gdino": GroundingDino,
           "zoedepth": ZoeDepthModel, "cotracker2": CoTracker2, "sam2": Sam2ImageModel}[name]
    with torch.device("meta"):
        return cls(cfg)


# family: (synthesised state dict, converter name and arguments, port module, its config, the port's
# *_from_jax, the scanned stack that tree holds (outer, inner) or None where the port's names follow
# the tree as it is, "torch" where they are the released names)
FAMILIES = {
    "dinov2-hf": (_dinov2_hf_sd, "dinov2_from_hf", (DINO_LAYERS,), "dinov2", _dinov2_cfg, "dinov2_from_jax",
                  "torch"),
    "dinov2-hub": (lambda: dinov2_hub_sd(DINO_LAYERS, DINO_WIDTH), "dinov2_from_hub", (DINO_LAYERS,), "dinov2",
                   _dinov2_cfg, "dinov2_from_jax", "torch"),
    "clip-hf": (_clip_hf_sd, "clip_from_hf", (48, 32), "clip", _clip_cfg, "clip_from_jax", ("layers", "layer")),
    "clip-openclip": (_clip_open_clip_sd, "clip_from_open_clip", (48, 32), "clip", _clip_cfg, "clip_from_jax",
                      ("layers", "layer")),
    "swin-hf": (_gdino_hf_sd, "swin_from_hf", (SWIN_DEPTHS, [1, 2, 3], "model.backbone.conv_encoder.model."),
                "swin", lambda: _gdino_cfg().swin, "swin_from_jax", None),
    "bert-hf": (_gdino_hf_sd, "bert_from_hf", (12, "model.text_backbone."), "bert", lambda: _gdino_cfg().text,
                "bert_from_jax", None),
    "grounding-dino-hf": (_gdino_hf_sd, "grounding_dino_from_hf", (SWIN_DEPTHS, [1, 2, 3], 12), "gdino",
                          _gdino_cfg, "grounding_dino_from_jax", None),
    "zoedepth-hf": (_zoedepth_hf_sd, "zoedepth_from_hf", (24,), "zoedepth", _zoedepth_cfg, "zoedepth_from_jax",
                    ("blocks", "block")),
    "cotracker2-hub": (cotracker2_hub_sd, "cotracker2_from_hub", (6,), "cotracker2", _cotracker2_cfg,
                       "cotracker2_from_jax", "torch"),
    # models/sam2/convert.py, which shares the state-dict helpers above
    "sam2-image-hf": (_sam2_hf_sd, "sam2_image_model_from_hf", (48,), "sam2", _sam2_cfg, "state_dict_from_jax",
                      None),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_matches_jax_and_loads_into_the_port(family):
    make_sd, fn, args, module, cfg, from_jax, names = FAMILIES[family]
    sd = make_sd()
    ours_mod, ref_mod = (sam2_convert, jax_sam2_convert) if family.startswith("sam2") else (C, JC)
    ours = getattr(ours_mod, fn)(sd, *args)
    _assert_trees_equal(ours, getattr(ref_mod, fn)(sd, *args))
    model = _module(module, cfg())
    model.load_state_dict(getattr(C, from_jax)(ours), strict=True, assign=True)  # every key, every shape
    if names != "torch":
        tree = ours if names is None else C.unstack_scanned(ours, *names)
        assert {p: tuple(np.shape(v)) for p, v in _leaves(tree)} == C.jax_param_shapes(model)


def test_cotracker2_from_hub_reads_the_virtual_tracks_either_spelling():
    sd = cotracker2_hub_sd()
    fixed = {k.replace("virual", "virtual"): v for k, v in sd.items()}
    _assert_trees_equal(C.cotracker2_from_hub(fixed), C.cotracker2_from_hub(sd))
    _assert_trees_equal(C.cotracker2_from_hub(fixed), JC.cotracker2_from_hub(fixed))


# --------------------------------------------------------------------- #
# The CLIs against the JAX scripts.


def _run_jax_script(name: str, argv: list[str], monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", [name, *argv])
    importlib.import_module(f"scripts.{name}").main()


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_convert_weights_dinov2_hf_matches_transformers_and_the_jax_cli(tmp_path, monkeypatch):
    """--kind dinov2-hf, then the port's DINOv2 on the CPU against
    transformers' Dinov2WithRegistersModel within 3e-4 (the JAX CLI's own
    round-trip bound); the .npz holds the JAX CLI's arrays."""
    from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel

    from freepose_tpu_torch.models.dinov2 import DinoV2
    from freepose_tpu_torch.scripts import convert_weights

    torch.manual_seed(0)
    hf = Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=256, patch_size=14,
        image_size=56, num_register_tokens=4, layerscale_value=0.5)).eval()
    ckpt = tmp_path / "dinov2.bin"
    torch.save(hf.state_dict(), ckpt)
    argv = ["--kind", "dinov2-hf", "--ckpt", str(ckpt), "--layers", "3"]
    convert_weights.main([*argv, "--out", str(tmp_path / "ours.npz")])
    _run_jax_script("convert_weights", [*argv, "--out", str(tmp_path / "ref.npz")], monkeypatch)
    ours, ref = _npz(tmp_path / "ours.npz"), _npz(tmp_path / "ref.npz")
    assert ours.keys() == ref.keys()
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)

    model = DinoV2(_dinov2_cfg(layers=3, heads=4, width=64)).eval()
    model.load_state_dict(C.dinov2_from_jax(C.load_params(tmp_path / "ours.npz")))
    img = torch.as_tensor(np.random.default_rng(0).normal(size=(1, 3, 56, 56)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model(img).numpy(), hf(img).last_hidden_state.numpy(), atol=3e-4)


def test_prepare_weights_skips_missing_families_and_matches_jax(tmp_path, monkeypatch, capsys):
    """Two of the seven families present (DINOv2-B hub at the released depth
    and CoTracker2 at its released depth, shrunken widths): both converted,
    five MISSING notes; the .npz files hold the JAX script's arrays."""
    from freepose_tpu_torch.scripts import prepare_weights

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(dinov2_hub_sd(12, 24), ckpt / "dinov2_vitb14_reg4_pretrain.pth")
    torch.save(cotracker2_hub_sd(), ckpt / "cotracker2.pth")
    prepare_weights.main(["--ckpt-dir", str(ckpt), "--out-dir", str(tmp_path / "ours")])
    out = capsys.readouterr().out
    assert out.count("MISSING") == 5 and f"2 families ready, 5 missing under {ckpt}/" in out
    _run_jax_script("prepare_weights", ["--ckpt-dir", str(ckpt), "--out-dir", str(tmp_path / "ref")], monkeypatch)
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir()) == ["cotracker2.npz", "dinov2_vitb.npz"]
    for name in names:
        ours, ref = _npz(tmp_path / "ours" / name), _npz(tmp_path / "ref" / name)
        assert ours.keys() == ref.keys()
        for key, val in ref.items():
            np.testing.assert_array_equal(ours[key], val, err_msg=f"{name}: {key}")
    prepare_weights.main(["--ckpt-dir", str(ckpt), "--out-dir", str(tmp_path / "ours")])
    assert capsys.readouterr().out.count("exists") == 2  # kept without --force


def test_resize_meshes_matches_jax(tmp_path, monkeypatch, capsys):
    """A coloured OBJ, a textured OBJ and one that fails to load: the same
    files byte for byte and the same summary. Both packages write the
    textured mesh with its atlas baked into vertex colours and no vt, MTL or
    atlas (save_obj writes vertices and faces only)."""
    from PIL import Image

    from freepose_tpu_torch.io.mesh import TriMesh, load_obj, save_obj
    from freepose_tpu_torch.scripts import resize_meshes

    rng = np.random.default_rng(0)
    meshes = tmp_path / "meshes"
    for name in ("aaa", "tex", "bad"):
        (meshes / name).mkdir(parents=True)
    v = rng.uniform(-3, 5, (20, 3)).astype(np.float32)
    save_obj(TriMesh(v, rng.integers(0, 20, (30, 3)).astype(np.int32), rng.random((20, 3)).astype(np.float32)),
             meshes / "aaa" / "aaa.obj")
    Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)).save(meshes / "tex" / "atlas.png")
    (meshes / "tex" / "m.mtl").write_text("newmtl m\nmap_Kd atlas.png\n")
    (meshes / "tex" / "tex.obj").write_text(
        "mtllib m.mtl\nv 0 0 1\nv 4 0 1\nv 4 2 1\nv 0 2 3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    (meshes / "bad" / "bad.obj").write_text("v 0 0 zero\nf 1 2 3\n")  # not a number
    resize_meshes.main(["--mesh-dir", str(meshes), "--out", str(tmp_path / "ours")])
    ours_out = capsys.readouterr().out
    _run_jax_script("resize_meshes", ["--mesh-dir", str(meshes), "--out", str(tmp_path / "ref")], monkeypatch)
    assert capsys.readouterr().out == ours_out
    assert "normalized 2 meshes (1 failures)" in ours_out and "failed bad" in ours_out
    for name in ("aaa", "tex"):
        ours, ref = (tmp_path / d / name / f"{name}.obj" for d in ("ours", "ref"))
        assert ours.read_bytes() == ref.read_bytes()
        mesh = load_obj(ours)
        lo, hi = mesh.bounds()
        np.testing.assert_allclose((hi + lo) / 2, 0, atol=1e-6)
        assert abs(mesh.half_extent() - 1.0) < 1e-6
    text = (tmp_path / "ours" / "tex" / "tex.obj").read_text()
    assert "vt" not in text and "mtllib" not in text and not list((tmp_path / "ours" / "tex").glob("*.png"))
    assert all(len(line.split()) == 7 for line in text.splitlines() if line.startswith("v "))


def test_merge_results_matches_jax(tmp_path, monkeypatch):
    import pandas as pd

    from freepose_tpu_torch.io.bop_csv import PoseResult, write_results_csv
    from freepose_tpu_torch.scripts import merge_results

    rng = np.random.default_rng(0)
    rows = [PoseResult(1, i, f"obj{i % 3}", float(rng.random()), np.eye(3), rng.normal(size=3),
                       rng.uniform(0, 100, 4), 0.1, 0.5) for i in range(7)]
    (tmp_path / "shards").mkdir()
    write_results_csv(rows, tmp_path / "all.csv")
    write_results_csv(rows[:3], tmp_path / "shards" / "part-0.csv")
    write_results_csv(rows[3:], tmp_path / "shards" / "part-1.csv")
    argv = ["--results-dir", str(tmp_path / "shards"), "--pattern", "part-*.csv"]
    merge_results.main([*argv, "--out", str(tmp_path / "ours.csv")])
    _run_jax_script("merge_results", [*argv, "--out", str(tmp_path / "ref.csv")], monkeypatch)
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "ours.csv"), pd.read_csv(tmp_path / "all.csv"))
    with pytest.raises(SystemExit, match="no CSVs"):
        merge_results.main(["--results-dir", str(tmp_path), "--pattern", "none-*.csv", "--out", "x.csv"])


def test_load_params_names_the_ports_convert_weights(tmp_path):
    ckpt = tmp_path / "dinov2.pth"
    torch.save({}, ckpt)
    with pytest.raises(ValueError, match=r"python -m freepose_tpu_torch\.scripts\.convert_weights") as err:
        C.load_params(ckpt)
    assert "JAX" not in str(err.value)
