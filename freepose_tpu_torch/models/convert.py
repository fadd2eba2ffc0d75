"""Carry weights across from the JAX package.

`dinov2_from_jax` maps the JAX package's DINOv2 parameter tree (nested dicts
of numpy arrays; the scanned blocks stacked [L, ...] under blocks/block/...)
onto the port's DinoV2 state_dict: Flax Dense kernels [in, out] become torch
Linear weights [out, in], the HWIO patch-embedding kernel becomes OIHW, and
LayerNorm scale/bias become weight/bias. `load_params` reads the flat
'/'-joined .npz that the JAX CLIs' `save_params` writes, so both packages take
the same --weights files. Pure numpy + torch; no JAX needed.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable, contiguous copy


def _dense(tree: dict, i: int | None = None) -> dict:
    k, b = tree["kernel"], tree["bias"]
    if i is not None:
        k, b = k[i], b[i]
    return {"weight": _f32(np.asarray(k).T), "bias": _f32(b)}


def _layernorm(tree: dict, i: int | None = None) -> dict:
    s, b = tree["scale"], tree["bias"]
    if i is not None:
        s, b = s[i], b[i]
    return {"weight": _f32(s), "bias": _f32(b)}


def dinov2_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX DinoV2 params -> freepose_tpu_torch DinoV2 state_dict (fp32; the
    model casts to its compute dtype on load)."""
    sd: dict[str, torch.Tensor] = {}
    pe = params["patch_embed"]
    sd["patch_embed.weight"] = _f32(np.asarray(pe["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    sd["patch_embed.bias"] = _f32(pe["bias"])
    for name in ("cls_token", "reg_tokens", "pos_embed"):
        sd[name] = _f32(params[name])
    for key, val in _layernorm(params["norm"]).items():
        sd[f"norm.{key}"] = val

    blk = params["blocks"]["block"]
    n_layers = np.asarray(blk["norm1"]["scale"]).shape[0]
    for i in range(n_layers):
        p = f"blocks.{i}"
        parts = {
            "norm1": _layernorm(blk["norm1"], i),
            "attn.qkv": _dense(blk["attn"]["qkv"], i),
            "attn.proj": _dense(blk["attn"]["proj"], i),
            "norm2": _layernorm(blk["norm2"], i),
            "mlp.fc1": _dense(blk["mlp"]["fc1"], i),
            "mlp.fc2": _dense(blk["mlp"]["fc2"], i),
        }
        for mod, tensors in parts.items():
            for key, val in tensors.items():
                sd[f"{p}.{mod}.{key}"] = val
        sd[f"{p}.ls1.gamma"] = _f32(blk["ls1"]["gamma"][i])
        sd[f"{p}.ls2.gamma"] = _f32(blk["ls2"]["gamma"][i])
    return sd


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params(path: str | Path) -> dict:
    """Flat '/'-joined .npz of JAX-layout params -> nested tree."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(
            f"unsupported weights file {path}; convert torch checkpoints with "
            "the JAX package's scripts.convert_weights and pass the .npz"
        )
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})
