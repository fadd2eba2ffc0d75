"""HF Sam2 checkpoint -> parameter converters for the SAM2 stack.

A copy of the JAX package's freepose_tpu/models/sam2/convert.py (it needs
only numpy; the state-dict helpers are models/convert.py's): it produces
the JAX package's parameter tree, which
freepose_tpu_torch/models/convert.py:sam2_video_from_jax maps onto the
port's modules."""
from __future__ import annotations

from freepose_tpu_torch.models.convert import _sd_dense as _dense
from freepose_tpu_torch.models.convert import _sd_layernorm as _ln
from freepose_tpu_torch.models.convert import _t


def _conv(sd, p):
    out = {"kernel": _t(sd[f"{p}.weight"]).transpose(2, 3, 1, 0)}
    if f"{p}.bias" in sd:
        out["bias"] = _t(sd[f"{p}.bias"])
    return out


def hiera_from_hf(sd: dict, total_blocks: int, prefix: str = "backbone") -> dict:
    """HF Sam2HieraDetModel state dict -> Hiera Flax params."""
    params = {
        "patch_embed": _conv(sd, f"{prefix}.patch_embed.projection"),
        "pos_embed": _t(sd[f"{prefix}.pos_embed"]).transpose(0, 2, 3, 1),
        "pos_embed_window": _t(sd[f"{prefix}.pos_embed_window"]).transpose(0, 2, 3, 1),
    }
    for i in range(total_blocks):
        p = f"{prefix}.blocks.{i}"
        blk = {
            "norm1": _ln(sd, f"{p}.layer_norm1"),
            "attn": {"qkv": _dense(sd, f"{p}.attn.qkv"), "proj": _dense(sd, f"{p}.attn.proj")},
            "norm2": _ln(sd, f"{p}.layer_norm2"),
            "mlp": {"fc1": _dense(sd, f"{p}.mlp.proj_in"), "fc2": _dense(sd, f"{p}.mlp.proj_out")},
        }
        if f"{p}.proj.weight" in sd:
            blk["proj"] = _dense(sd, f"{p}.proj")
        params[f"block{i}"] = blk
    return params


def fpn_neck_from_hf(sd: dict, n_convs: int, prefix: str = "neck") -> dict:
    return {f"conv{j}": _conv(sd, f"{prefix}.convs.{j}") for j in range(n_convs)}


def _ffn(sd, p, n_layers):
    out = {"proj_in": _dense(sd, f"{p}.proj_in"), "proj_out": _dense(sd, f"{p}.proj_out")}
    for i in range(n_layers - 2):
        out[f"layer{i}"] = _dense(sd, f"{p}.layers.{i}")
    return out


def _decoder_attn(sd, p):
    return {
        "q": _dense(sd, f"{p}.q_proj"),
        "k": _dense(sd, f"{p}.k_proj"),
        "v": _dense(sd, f"{p}.v_proj"),
        "out": _dense(sd, f"{p}.o_proj"),
    }


def _convT(sd, p):
    return {
        "kernel": _t(sd[f"{p}.weight"]).transpose(2, 3, 0, 1),
        "bias": _t(sd[f"{p}.bias"]),
    }


def prompt_encoder_from_hf(sd: dict, prefix: str = "prompt_encoder") -> dict:
    return {
        "pe_matrix": _t(sd[f"{prefix}.shared_embedding.positional_embedding"]),
        "point_embed": _t(sd[f"{prefix}.point_embed.weight"]),
        "not_a_point": _t(sd[f"{prefix}.not_a_point_embed.weight"]),
        "no_mask": _t(sd[f"{prefix}.no_mask_embed.weight"]),
        "mask_embed": {
            "conv1": _conv(sd, f"{prefix}.mask_embed.conv1"),
            "ln1": _ln(sd, f"{prefix}.mask_embed.layer_norm1"),
            "conv2": _conv(sd, f"{prefix}.mask_embed.conv2"),
            "ln2": _ln(sd, f"{prefix}.mask_embed.layer_norm2"),
            "conv3": _conv(sd, f"{prefix}.mask_embed.conv3"),
        },
    }


def mask_decoder_from_hf(sd: dict, num_layers: int = 2, num_mask_tokens: int = 4, prefix: str = "mask_decoder") -> dict:
    params = {
        "obj_score_token": _t(sd[f"{prefix}.obj_score_token.weight"]),
        "iou_token": _t(sd[f"{prefix}.iou_token.weight"]),
        "mask_tokens": _t(sd[f"{prefix}.mask_tokens.weight"]),
        "ln_final": _ln(sd, f"{prefix}.transformer.layer_norm_final_attn"),
        "final_t2i": _decoder_attn(sd, f"{prefix}.transformer.final_attn_token_to_image"),
        "upscale1": _convT(sd, f"{prefix}.upscale_conv1"),
        "upscale2": _convT(sd, f"{prefix}.upscale_conv2"),
        "upscale_ln": _ln(sd, f"{prefix}.upscale_layer_norm"),
        "iou_head": _ffn(sd, f"{prefix}.iou_prediction_head", 3),
        "obj_head": _ffn(sd, f"{prefix}.pred_obj_score_head", 3),
    }
    for i in range(num_layers):
        p = f"{prefix}.transformer.layers.{i}"
        params[f"block{i}"] = {
            "self_attn": _decoder_attn(sd, f"{p}.self_attn"),
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "cross_t2i": _decoder_attn(sd, f"{p}.cross_attn_token_to_image"),
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "mlp": _ffn(sd, f"{p}.mlp", 2),
            "ln3": _ln(sd, f"{p}.layer_norm3"),
            "cross_i2t": _decoder_attn(sd, f"{p}.cross_attn_image_to_token"),
            "ln4": _ln(sd, f"{p}.layer_norm4"),
        }
    for i in range(num_mask_tokens):
        params[f"hyper{i}"] = _ffn(sd, f"{prefix}.output_hypernetworks_mlps.{i}", 3)
    return params


def sam2_image_model_from_hf(sd: dict, total_blocks: int, n_convs: int = 4, decoder_layers: int = 2) -> dict:
    """Full HF Sam2Model state dict -> Sam2ImageModel Flax params."""
    return {
        "backbone": hiera_from_hf(sd, total_blocks, prefix="vision_encoder.backbone"),
        "neck": fpn_neck_from_hf(sd, n_convs, prefix="vision_encoder.neck"),
        "prompt_encoder": prompt_encoder_from_hf(sd),
        "decoder": mask_decoder_from_hf(sd, decoder_layers),
        "no_memory_embedding": _t(sd["no_memory_embedding"]),
        "conv_s0": _conv(sd, "mask_decoder.conv_s0"),
        "conv_s1": _conv(sd, "mask_decoder.conv_s1"),
    }


def _rope_attn(sd, p):
    return {
        "q": _dense(sd, f"{p}.q_proj"),
        "k": _dense(sd, f"{p}.k_proj"),
        "v": _dense(sd, f"{p}.v_proj"),
        "out": _dense(sd, f"{p}.o_proj"),
    }


def memory_attention_from_hf(sd: dict, num_layers: int = 4, prefix: str = "memory_attention") -> dict:
    params = {"ln_final": _ln(sd, f"{prefix}.layer_norm")}
    for i in range(num_layers):
        p = f"{prefix}.layers.{i}"
        params[f"layer{i}"] = {
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "self_attn": _rope_attn(sd, f"{p}.self_attn"),
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "cross_attn": _rope_attn(sd, f"{p}.cross_attn_image"),
            "ln3": _ln(sd, f"{p}.layer_norm3"),
            "fc1": _dense(sd, f"{p}.linear1"),
            "fc2": _dense(sd, f"{p}.linear2"),
        }
    return params


def memory_encoder_from_hf(sd: dict, n_down_layers: int = 4, n_fuser: int = 2, prefix: str = "memory_encoder") -> dict:
    params = {
        "feature_proj": _conv(sd, f"{prefix}.feature_projection"),
        "out_proj": _conv(sd, f"{prefix}.projection"),
        "mask_down": {"final_conv": _conv(sd, f"{prefix}.mask_downsampler.final_conv")},
    }
    for i in range(n_down_layers):
        params["mask_down"][f"conv{i}"] = _conv(sd, f"{prefix}.mask_downsampler.layers.{i}.conv")
        params["mask_down"][f"ln{i}"] = _ln(sd, f"{prefix}.mask_downsampler.layers.{i}.layer_norm")
    for i in range(n_fuser):
        p = f"{prefix}.memory_fuser.layers.{i}"
        params[f"fuser{i}"] = {
            "dwconv": _conv(sd, f"{p}.depthwise_conv"),
            "ln": _ln(sd, f"{p}.layer_norm"),
            "pw1": _dense(sd, f"{p}.pointwise_conv1"),
            "pw2": _dense(sd, f"{p}.pointwise_conv2"),
            "scale": _t(sd[f"{p}.scale"]),
        }
    return params


def sam2_video_model_from_hf(sd: dict, total_blocks: int, mem_layers: int = 4, decoder_layers: int = 2) -> dict:
    """Full HF Sam2VideoModel state dict -> Sam2VideoModel Flax params."""
    params = {
        "image": sam2_image_model_from_hf(sd, total_blocks, decoder_layers=decoder_layers),
        "memory_attention": memory_attention_from_hf(sd, mem_layers),
        "memory_encoder": memory_encoder_from_hf(sd),
        "memory_temporal_pos": _t(sd["memory_temporal_positional_encoding"]),
        "no_object_pointer": _t(sd["no_object_pointer"]),
        "no_memory_pos": _t(sd["no_memory_positional_encoding"]),
        "obj_ptr_proj": _ffn(sd, "object_pointer_proj", 3),
        "mask_downsample": _conv(sd, "mask_downsample"),
    }
    if "temporal_positional_encoding_projection_layer.weight" in sd:
        params["ptr_tpos_proj"] = _dense(sd, "temporal_positional_encoding_projection_layer")
    if "occlusion_spatial_embedding_parameter" in sd:
        params["occlusion_embedding"] = _t(sd["occlusion_spatial_embedding_parameter"])
    return params
