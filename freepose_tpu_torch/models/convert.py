"""Carry weights across from the JAX package.

`dinov2_from_jax` maps the JAX package's DINOv2 parameter tree (nested dicts
of numpy arrays; the scanned blocks stacked [L, ...] under blocks/block/...)
onto the port's DinoV2 state_dict: Flax Dense kernels [in, out] become torch
Linear weights [out, in], the HWIO patch-embedding kernel becomes OIHW, and
LayerNorm scale/bias become weight/bias. The SAM2, ZoeDepth, CLIP, Swin,
BERT and GroundingDINO modules carry the JAX names, so `state_dict_from_jax`
maps their trees leaf by leaf (`zoedepth_from_jax` and `clip_from_jax` first
unstack the scanned blocks, `cotracker_from_jax` flattens the learned
CoTracker's attention kernels).
`load_params` reads the flat '/'-joined .npz that the JAX CLIs' `save_params`
writes, so both packages take the same --weights files. Pure numpy + torch;
no JAX needed.

The released-checkpoint converters (`dinov2_from_hf`, `dinov2_from_hub`,
`clip_from_hf`, `clip_from_open_clip`, `swin_from_hf`, `bert_from_hf`,
`grounding_dino_from_hf`, `zoedepth_from_hf`, `cotracker2_from_hub`; SAM2's
are in models/sam2/convert.py) map a torch.hub or HF state dict (any mapping
of name -> array or tensor) onto that JAX-layout tree, pure numpy, as the JAX
package's converters do; scripts/convert_weights.py saves it as the .npz.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# Added to the SAM2 object-score head's output bias in random parameters, so
# that random weights keep every tracked object present: a negative object
# score blanks the object's masks, and retrieval then has nothing to score.
OBJECT_SCORE_BIAS = 10.0


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable, contiguous copy


def _t(x) -> np.ndarray:
    """A state dict's array or (CPU) tensor -> a float32 numpy array."""
    arr = np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)
    return arr.astype(np.float32)


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


def save_params(params: dict, path: str | Path) -> None:
    """Nested tree -> the flat '/'-joined .npz that `load_params` reads (the
    JAX package's scripts.common.save_params format)."""
    np.savez(Path(path), **{"/".join(p): np.asarray(v) for p, v in _tree_leaves(params)})


def load_params(path: str | Path) -> dict:
    """Flat '/'-joined .npz of JAX-layout params -> nested tree."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(
            f"unsupported weights file {path}; convert torch checkpoints with "
            "python -m freepose_tpu_torch.scripts.convert_weights and pass the .npz"
        )
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def _tree_leaves(tree: dict, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _tree_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX parameter tree (nested dicts of numpy arrays) -> the state_dict
    of a port module whose names follow the tree (fp32; the model casts to
    its compute dtypes on load). The map is by leaf: Dense kernels [in, out]
    -> Linear weights [out, in]; HWIO conv kernels -> OIHW; the
    transposed-conv kernels of SAM2's upscaler, which Flax applies
    unflipped, -> flipped [in, out, kh, kw]; LayerNorm scale -> weight;
    every other parameter keeps its name and shape."""
    siblings: dict[tuple, set] = {}
    for path, _ in _tree_leaves(params):
        siblings.setdefault(path[:-1], set()).add(path[-1])
    sd: dict[str, torch.Tensor] = {}
    for path, val in _tree_leaves(params):
        parent, leaf = path[:-1], path[-1]
        arr = np.asarray(val, dtype=np.float32)
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif parent[-1].startswith("upscale"):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "scale" and siblings[parent] == {"scale", "bias"}:
            leaf = "weight"
        sd[".".join(parent + (leaf,))] = _f32(arr)
    return sd


def sam2_video_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX Sam2VideoModel params -> freepose_tpu_torch Sam2VideoModel
    state_dict (`state_dict_from_jax`)."""
    return state_dict_from_jax(params)


def unstack_scanned(tree: dict, outer: str, inner: str) -> dict:
    """Replace every scanned stack {outer: {inner: subtree of [L, ...]
    leaves}} (a Flax nn.scan) by {outer: {"0": layer 0, ..., "L-1": ...}},
    the paths of an nn.ModuleList named `outer`."""
    out = {}
    for key, val in tree.items():
        if not isinstance(val, dict):
            out[key] = val
        elif key == outer and set(val) == {inner}:
            n_layers = len(next(v for _, v in _tree_leaves(val[inner])))
            out[key] = {str(i): _index_tree(val[inner], i) for i in range(n_layers)}
        else:
            out[key] = unstack_scanned(val, outer, inner)
    return out


def stack_scanned(tree: dict, outer: str, inner: str) -> dict:
    """The inverse of `unstack_scanned`."""
    out = {}
    for key, val in tree.items():
        if not isinstance(val, dict):
            out[key] = val
        elif key == outer and set(val) == {str(i) for i in range(len(val))}:
            out[key] = {inner: _stack_trees([val[str(i)] for i in range(len(val))])}
        else:
            out[key] = stack_scanned(val, outer, inner)
    return out


def _index_tree(tree: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _stack_trees(trees: list[dict]) -> dict:
    return {k: _stack_trees([t[k] for t in trees]) if isinstance(v, dict) else np.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def zoedepth_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ZoeDepthModel params (the BEiT blocks scanned: backbone/blocks/
    block/* stacked [L, ...]) -> freepose_tpu_torch ZoeDepthModel
    state_dict. The reassemble stage's resize{i}_w is torch's
    ConvTranspose2d layout in both trees and is not flipped."""
    return state_dict_from_jax(unstack_scanned(params, "blocks", "block"))


def clip_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX Clip params (visual|text/layers/layer/* stacked [L, ...]) ->
    freepose_tpu_torch Clip state_dict."""
    return state_dict_from_jax(unstack_scanned(params, "layers", "layer"))


def jax_param_shapes(model: torch.nn.Module) -> dict[tuple, tuple]:
    """The JAX parameter tree's leaf paths and shapes for a port module whose
    names follow the JAX tree (the inverse of `state_dict_from_jax`)."""
    shapes = {}
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for name, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if name == "weight" and isinstance(mod, torch.nn.Linear):
                name, shape = "kernel", shape[::-1]
            elif name == "weight" and isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                name = "scale"
            elif name == "weight" and isinstance(mod, torch.nn.ConvTranspose2d):
                name, shape = "kernel", (shape[2], shape[3], shape[0], shape[1])
            elif name == "weight" and isinstance(mod, torch.nn.Conv2d):
                name, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
            shapes[prefix + (name,)] = shape
    return shapes


def random_jax_params(model: torch.nn.Module, seed: int = 0) -> dict:
    """Seeded random parameters for a port module, in the JAX package's tree
    layout (see `jax_param_shapes`): lecun-normal kernels, N(0, 0.02) biases
    and embeddings, LayerNorm scales 1 + N(0, 0.02), the prompt encoder's
    Fourier matrix N(0, 1), and OBJECT_SCORE_BIAS on the SAM2 object-score
    head's output bias."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape in jax_param_shapes(model).items():
        if path[-1] == "kernel":
            val = rng.standard_normal(shape, np.float32) / np.float32(np.sqrt(np.prod(shape[:-1])))
        elif path[-1] == "pe_matrix":
            val = rng.standard_normal(shape, np.float32)
        elif path[-1] == "scale" and path[-2].startswith(("ln", "norm", "upscale_ln")):
            val = 1.0 + 0.02 * rng.standard_normal(shape, np.float32)
        else:
            val = 0.02 * rng.standard_normal(shape, np.float32)
        if path[-3:] == ("obj_head", "proj_out", "bias"):
            val = val + np.float32(OBJECT_SCORE_BIAS)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val.astype(np.float32, copy=False)
    return tree


def random_sam2_video_params(cfg, seed: int = 0) -> dict:
    """`random_jax_params` of a Sam2VideoModel at `cfg` (built on the meta
    device: shapes only)."""
    from freepose_tpu_torch.models.sam2.video import Sam2VideoModel

    with torch.device("meta"):
        model = Sam2VideoModel(cfg)
    return random_jax_params(model, seed)


def random_zoedepth_params(cfg, seed: int = 0) -> dict:
    """`random_jax_params` of a ZoeDepthModel at `cfg`, with the BEiT blocks
    stacked as the JAX tree scans them (backbone/blocks/block/*)."""
    from freepose_tpu_torch.models.zoedepth import ZoeDepthModel

    with torch.device("meta"):
        model = ZoeDepthModel(cfg)
    return stack_scanned(random_jax_params(model, seed), "blocks", "block")


def random_sam2_image_params(cfg, seed: int = 0) -> dict:
    """`random_jax_params` of a Sam2ImageModel at `cfg` (the "image" subtree
    of a Sam2VideoModel's tree)."""
    from freepose_tpu_torch.models.sam2.model import Sam2ImageModel

    with torch.device("meta"):
        model = Sam2ImageModel(cfg)
    return random_jax_params(model, seed)


def swin_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX SwinBackbone params -> freepose_tpu_torch SwinBackbone state_dict
    (`state_dict_from_jax`: the port's names follow the JAX tree)."""
    return state_dict_from_jax(params)


def bert_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX Bert params -> freepose_tpu_torch Bert state_dict."""
    return state_dict_from_jax(params)


def grounding_dino_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX GroundingDino params (text_backbone = Bert, backbone = Swin, the
    GroupNorm scales mapped like LayerNorm's) -> freepose_tpu_torch
    GroundingDino state_dict."""
    return state_dict_from_jax(params)


def random_grounding_dino_params(cfg, seed: int = 0) -> dict:
    """`random_jax_params` of a GroundingDino at `cfg`, with every LayerNorm
    and GroupNorm scale drawn 1 + N(0, 0.02) (the name rule of
    `random_jax_params` does not see GroundingDINO's norm names), then the
    scales of the two norms whose outputs meet the text in the contrastive
    logits and feed the box heads (enc_output_norm, decoder_ln) divided by
    sqrt(d_model): the logits, a d_model-wide product of two normalised
    vectors, are then O(1) as a trained model's are, so the sigmoid scores do
    not saturate at 1, and the box deltas stay small, so boxes keep near
    their anchors."""
    from freepose_tpu_torch.models.grounding_dino import GroundingDino

    with torch.device("meta"):
        model = GroundingDino(cfg)
    tree = random_jax_params(model, seed)
    rng = np.random.default_rng(seed + 1)
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            node = tree
            for key in name.split("."):
                node = node[key]
            node["scale"] = (1.0 + 0.02 * rng.standard_normal(node["scale"].shape, np.float32)).astype(np.float32)
    for name in ("enc_output_norm", "decoder_ln"):
        tree[name]["scale"] = tree[name]["scale"] / np.float32(np.sqrt(cfg.d_model))
    return tree


def _map_attention(tree: dict, fn) -> dict:
    """A copy of the learned CoTracker's tree with `fn(leaf path, array)`
    applied to every leaf of its attention modules (…_attn/{query, key,
    value, out})."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = ({name: {leaf: fn((name, leaf), np.asarray(x)) for leaf, x in sub.items()}
                         for name, sub in val.items()} if key.endswith("_attn") else _map_attention(val, fn))
        else:
            out[key] = val
    return out


def cotracker_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX learned CoTracker's tree -> the state dict of the port's
    CoTracker. Its attention kernels are Flax DenseGeneral kernels, [D, H,
    Dh] for q/k/v (biases [H, Dh]) and [H, Dh, D] for out, which
    `state_dict_from_jax` would take for conv kernels: they are flattened to
    the [D, D] Dense layout first; everything else maps leaf by leaf."""
    def flatten(path, x):
        name, leaf = path
        if name == "out" and leaf == "kernel":
            return x.reshape(-1, x.shape[-1])
        return x.reshape(x.shape[0], -1) if leaf == "kernel" else x.reshape(-1)

    return state_dict_from_jax(_map_attention(params, flatten))


def random_cotracker_params(cfg, seed: int = 0) -> dict:
    """Seeded random parameters of the learned CoTracker at `cfg`, in the JAX
    package's tree layout (in place of Flax's init): lecun-normal kernels,
    N(0, 0.02) biases and time embedding, norm scales 1 + N(0, 0.02)."""
    from freepose_tpu_torch.models.cotracker import CoTracker

    with torch.device("meta"):
        model = CoTracker(cfg)
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape in jax_param_shapes(model).items():
        if path[-1] == "kernel":
            val = rng.standard_normal(shape, np.float32) / np.float32(np.sqrt(np.prod(shape[:-1])))
        elif path[-1] == "scale":
            val = 1.0 + 0.02 * rng.standard_normal(shape, np.float32)
        else:
            val = 0.02 * rng.standard_normal(shape, np.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val.astype(np.float32, copy=False)
    heads = cfg.num_heads

    def unflatten(path, x):  # the [D, D] Dense layout -> Flax's DenseGeneral
        name, leaf = path
        if leaf == "kernel":
            return x.reshape(heads, -1, x.shape[-1]) if name == "out" else x.reshape(x.shape[0], heads, -1)
        return x if name == "out" else x.reshape(heads, -1)

    return _map_attention(tree, unflatten)


# Added to the CoTracker2 visibility probe's bias in random parameters, so
# that random weights keep tracked points visible (above the predictor's 0.9
# threshold): with no visible point an interval has nothing to solve EPnP on.
VISIBILITY_BIAS = 10.0


def _cotracker2_leaves(depth: int):
    """(released state-dict name, JAX tree path, kind, scanned layer or None)
    for every CoTracker2 parameter. kind: "conv" (OIHW <-> HWIO), "dense"
    (weight [out, in] <-> kernel [in, out]), "norm" (weight <-> scale),
    "virtual" ([1, V, 1, D] <-> [V, 1, D])."""
    out = []

    def add(name, path, kind, layer=None, bias=True):
        w = {"conv": "kernel", "dense": "kernel", "norm": "scale"}[kind]
        out.append((f"{name}.weight", path + (w,), kind, layer))
        if bias:
            out.append((f"{name}.bias", path + ("bias",), "bias", layer))

    for conv in ("conv1", "conv2", "conv3"):
        add(f"fnet.{conv}", ("fnet", conv), "conv")
    for stage in range(1, 5):
        for blk in range(2):
            p, jp = f"fnet.layer{stage}.{blk}", ("fnet", f"layer{stage}_{blk}")
            add(f"{p}.conv1", jp + ("conv1",), "conv")
            add(f"{p}.conv2", jp + ("conv2",), "conv")
            if stage > 1 and blk == 0:
                add(f"{p}.downsample.0", jp + ("down",), "conv")
    add("updateformer.input_transform", ("updateformer", "input_transform"), "dense")
    add("updateformer.flow_head", ("updateformer", "flow_head"), "dense")
    out.append(("updateformer.virual_tracks", ("updateformer", "virtual_tracks"), "virtual", None))
    blocks = (("time_blocks", "time", "attn"), ("space_virtual_blocks", "virtual", "attn"),
              ("space_point2virtual_blocks", "point2virtual", "cross_attn"),
              ("space_virtual2point_blocks", "virtual2point", "cross_attn"))
    for i in range(depth):
        for torch_list, jax_name, attn in blocks:
            p, jp = f"updateformer.{torch_list}.{i}", ("updateformer", "layers", jax_name)
            for lin in ("to_q", "to_kv", "to_out"):
                add(f"{p}.{attn}.{lin}", jp + (attn, lin), "dense", i)
            for fc in ("fc1", "fc2"):
                add(f"{p}.mlp.{fc}", jp + ("mlp", fc), "dense", i)
            if attn == "cross_attn":
                add(f"{p}.norm_context", jp + ("norm_context",), "norm", i)
    add("norm", ("norm",), "norm")
    add("track_feat_updater.0", ("track_feat_updater",), "dense")
    add("vis_predictor.0", ("vis_predictor",), "dense")
    return out


def _to_torch_layout(x: np.ndarray, kind: str) -> np.ndarray:
    return {"conv": lambda a: a.transpose(3, 2, 0, 1), "dense": lambda a: a.T,
            "virtual": lambda a: a[None]}.get(kind, lambda a: a)(x)


def _to_jax_layout(x: np.ndarray, kind: str) -> np.ndarray:
    return {"conv": lambda a: a.transpose(2, 3, 1, 0), "dense": lambda a: a.T,
            "virtual": lambda a: a[0]}.get(kind, lambda a: a)(x)


def cotracker2_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX CoTracker2 parameter tree (its 6 layers scanned, stacked
    [depth, ...] under updateformer/layers) -> the state dict of the port's
    CoTracker2, whose names are the released checkpoint's."""
    depth = np.asarray(params["updateformer"]["layers"]["time"]["mlp"]["fc1"]["bias"]).shape[0]
    sd = {}
    for name, path, kind, layer in _cotracker2_leaves(depth):
        node = params
        for key in path:
            node = node[key]
        x = np.asarray(node)
        sd[name] = _f32(_to_torch_layout(x if layer is None else x[layer], kind))
    return sd


def cotracker2_to_jax(sd: dict, depth: int | None = None) -> dict:
    """The inverse of `cotracker2_from_jax`: a CoTracker2 state dict (the
    released names) -> the JAX tree, of its first `depth` update-former
    layers (default: all it holds)."""
    if depth is None:
        depth = len({k.split(".")[2] for k in sd if k.startswith("updateformer.time_blocks.")})
    tree: dict = {}
    stacked: dict = {}
    for name, path, kind, layer in _cotracker2_leaves(depth):
        x = _to_jax_layout(_t(sd[name]), kind)
        if layer is not None:
            stacked.setdefault(path, [None] * depth)[layer] = x
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    for path, xs in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(xs)
    return tree


def random_cotracker2_params(cfg, seed: int = 0) -> dict:
    """Seeded random CoTracker2 parameters at `cfg` in the JAX package's tree
    layout: lecun-normal weights, N(0, 0.02) biases, norm scales
    1 + N(0, 0.02), virtual tracks N(0, 1), and VISIBILITY_BIAS added to the
    visibility probe's bias."""
    from freepose_tpu_torch.models.cotracker2 import CoTracker2

    with torch.device("meta"):
        model = CoTracker2(cfg)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name == "updateformer.virual_tracks":
            val = rng.standard_normal(shape, np.float32)
        elif name.endswith(".bias"):
            val = 0.02 * rng.standard_normal(shape, np.float32)
        elif len(shape) == 1:  # a norm's scale
            val = 1.0 + 0.02 * rng.standard_normal(shape, np.float32)
        else:
            val = rng.standard_normal(shape, np.float32) / np.float32(np.sqrt(np.prod(shape[1:])))
        sd[name] = val.astype(np.float32)
    sd["vis_predictor.0.bias"] = sd["vis_predictor.0.bias"] + np.float32(VISIBILITY_BIAS)
    return cotracker2_to_jax(sd)


# --------------------------------------------------------------------- #
# Released checkpoints (torch.hub / HF state dicts) -> the JAX-layout tree.


def _sd_dense(sd, prefix):
    return {"kernel": _t(sd[f"{prefix}.weight"]).T, "bias": _t(sd[f"{prefix}.bias"])}


def _sd_layernorm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _sd_conv(sd, prefix, bias=True):
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if bias:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _sd_fused_qkv(sd, prefix, names=("query", "key", "value")):
    """Separate q, k, v projections -> one Dense over their concatenation."""
    ws = [_t(sd[f"{prefix}.{n}.weight"]) for n in names]
    bs = [_t(sd[f"{prefix}.{n}.bias"]) for n in names]
    return {"kernel": np.concatenate(ws, axis=0).T, "bias": np.concatenate(bs)}


def _dinov2_common(sd, patch, cls, reg, pos, norm) -> dict:
    return {
        "patch_embed": {"kernel": _t(sd[f"{patch}.weight"]).transpose(2, 3, 1, 0), "bias": _t(sd[f"{patch}.bias"])},
        "cls_token": _t(sd[cls]),
        "reg_tokens": _t(sd[reg]),
        "pos_embed": _t(sd[pos]),
        "norm": _sd_layernorm(sd, norm),
    }


def dinov2_from_hf(state_dict: dict, num_layers: int) -> dict:
    """HF Dinov2WithRegistersModel state dict -> the JAX DinoV2 tree.

    HF layout: embeddings.* + encoder.layer.{i}.{norm1,
    attention.attention.{query,key,value}, attention.output.dense,
    layer_scale1.lambda1, norm2, mlp.fc1/fc2, layer_scale2.lambda1} +
    layernorm."""
    sd = state_dict
    params = _dinov2_common(sd, "embeddings.patch_embeddings.projection", "embeddings.cls_token",
                            "embeddings.register_tokens", "embeddings.position_embeddings", "layernorm")
    layers = []
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        layers.append({
            "norm1": _sd_layernorm(sd, f"{p}.norm1"),
            "attn": {"qkv": _sd_fused_qkv(sd, f"{p}.attention.attention"),
                     "proj": _sd_dense(sd, f"{p}.attention.output.dense")},
            "ls1": {"gamma": _t(sd[f"{p}.layer_scale1.lambda1"])},
            "norm2": _sd_layernorm(sd, f"{p}.norm2"),
            "mlp": {"fc1": _sd_dense(sd, f"{p}.mlp.fc1"), "fc2": _sd_dense(sd, f"{p}.mlp.fc2")},
            "ls2": {"gamma": _t(sd[f"{p}.layer_scale2.lambda1"])},
        })
    params["blocks"] = {"block": _stack_trees(layers)}
    return params


def dinov2_from_hub(state_dict: dict, num_layers: int) -> dict:
    """facebookresearch/dinov2 torch.hub state dict -> the JAX DinoV2 tree.

    Hub layout: patch_embed.proj, cls_token, register_tokens, pos_embed,
    blocks.{i}.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1/fc2,
    ls2.gamma}, norm (mask_token unused)."""
    sd = state_dict
    params = _dinov2_common(sd, "patch_embed.proj", "cls_token", "register_tokens", "pos_embed", "norm")
    layers = []
    for i in range(num_layers):
        p = f"blocks.{i}"
        layers.append({
            "norm1": _sd_layernorm(sd, f"{p}.norm1"),
            "attn": {"qkv": _sd_dense(sd, f"{p}.attn.qkv"), "proj": _sd_dense(sd, f"{p}.attn.proj")},
            "ls1": {"gamma": _t(sd[f"{p}.ls1.gamma"])},
            "norm2": _sd_layernorm(sd, f"{p}.norm2"),
            "mlp": {"fc1": _sd_dense(sd, f"{p}.mlp.fc1"), "fc2": _sd_dense(sd, f"{p}.mlp.fc2")},
            "ls2": {"gamma": _t(sd[f"{p}.ls2.gamma"])},
        })
    params["blocks"] = {"block": _stack_trees(layers)}
    return params


def _clip_layer(sd, p):
    return {
        "ln1": _sd_layernorm(sd, f"{p}.layer_norm1"),
        "qkv": _sd_fused_qkv(sd, f"{p}.self_attn", ("q_proj", "k_proj", "v_proj")),
        "proj": _sd_dense(sd, f"{p}.self_attn.out_proj"),
        "ln2": _sd_layernorm(sd, f"{p}.layer_norm2"),
        "fc1": _sd_dense(sd, f"{p}.mlp.fc1"),
        "fc2": _sd_dense(sd, f"{p}.mlp.fc2"),
    }


def clip_from_hf(state_dict: dict, vision_layers: int, text_layers: int) -> dict:
    """HF transformers CLIPModel state dict -> the JAX Clip tree."""
    sd = state_dict
    visual = {
        "patch_embed": {"kernel": _t(sd["vision_model.embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": _t(sd["vision_model.embeddings.class_embedding"]),
        "pos_embed": _t(sd["vision_model.embeddings.position_embedding.weight"]),
        "ln_pre": _sd_layernorm(sd, "vision_model.pre_layrnorm"),
        "ln_post": _sd_layernorm(sd, "vision_model.post_layernorm"),
        "proj": _t(sd["visual_projection.weight"]).T,
        "layers": {"layer": _stack_trees(
            [_clip_layer(sd, f"vision_model.encoder.layers.{i}") for i in range(vision_layers)])},
    }
    text = {
        "token_embedding": _t(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_embed": _t(sd["text_model.embeddings.position_embedding.weight"]),
        "ln_final": _sd_layernorm(sd, "text_model.final_layer_norm"),
        "text_proj": _t(sd["text_projection.weight"]).T,
        "layers": {"layer": _stack_trees(
            [_clip_layer(sd, f"text_model.encoder.layers.{i}") for i in range(text_layers)])},
    }
    return {"visual": visual, "text": text}


def _open_clip_layer(sd, p):
    """open_clip resblock (attn.in_proj_weight: the fused qkv)."""
    return {
        "ln1": _sd_layernorm(sd, f"{p}.ln_1"),
        "qkv": {"kernel": _t(sd[f"{p}.attn.in_proj_weight"]).T, "bias": _t(sd[f"{p}.attn.in_proj_bias"])},
        "proj": _sd_dense(sd, f"{p}.attn.out_proj"),
        "ln2": _sd_layernorm(sd, f"{p}.ln_2"),
        "fc1": _sd_dense(sd, f"{p}.mlp.c_fc"),
        "fc2": _sd_dense(sd, f"{p}.mlp.c_proj"),
    }


def clip_from_open_clip(state_dict: dict, vision_layers: int, text_layers: int) -> dict:
    """open_clip state dict (e.g. ViT-bigG-14 laion2b) -> the JAX Clip tree."""
    sd = state_dict
    visual = {
        "patch_embed": {"kernel": _t(sd["visual.conv1.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": _t(sd["visual.class_embedding"]),
        "pos_embed": _t(sd["visual.positional_embedding"]),
        "ln_pre": _sd_layernorm(sd, "visual.ln_pre"),
        "ln_post": _sd_layernorm(sd, "visual.ln_post"),
        "proj": _t(sd["visual.proj"]),
        "layers": {"layer": _stack_trees(
            [_open_clip_layer(sd, f"visual.transformer.resblocks.{i}") for i in range(vision_layers)])},
    }
    text = {
        "token_embedding": _t(sd["token_embedding.weight"]),
        "pos_embed": _t(sd["positional_embedding"]),
        "ln_final": _sd_layernorm(sd, "ln_final"),
        "text_proj": _t(sd["text_projection"]),
        "layers": {"layer": _stack_trees(
            [_open_clip_layer(sd, f"transformer.resblocks.{i}") for i in range(text_layers)])},
    }
    return {"visual": visual, "text": text}


def swin_from_hf(sd: dict, depths, out_stages, prefix: str = "") -> dict:
    """HF SwinBackbone / SwinModel state dict -> the JAX SwinBackbone tree."""
    p = prefix
    params = {
        "patch_embed": _sd_conv(sd, f"{p}embeddings.patch_embeddings.projection"),
        "embed_norm": _sd_layernorm(sd, f"{p}embeddings.norm"),
    }
    for stage, depth in enumerate(depths):
        for blk in range(depth):
            bp = f"{p}encoder.layers.{stage}.blocks.{blk}"
            params[f"stage{stage}_block{blk}"] = {
                "ln1": _sd_layernorm(sd, f"{bp}.layernorm_before"),
                "qkv": _sd_fused_qkv(sd, f"{bp}.attention.self"),
                "rel_bias_table": _t(sd[f"{bp}.attention.self.relative_position_bias_table"]),
                "proj": _sd_dense(sd, f"{bp}.attention.output.dense"),
                "ln2": _sd_layernorm(sd, f"{bp}.layernorm_after"),
                "fc1": _sd_dense(sd, f"{bp}.intermediate.dense"),
                "fc2": _sd_dense(sd, f"{bp}.output.dense"),
            }
        down = f"{p}encoder.layers.{stage}.downsample"
        if f"{down}.reduction.weight" in sd:
            params[f"downsample{stage}"] = {
                "norm": _sd_layernorm(sd, f"{down}.norm"),
                "reduction": {"kernel": _t(sd[f"{down}.reduction.weight"]).T},
            }
    for stage in out_stages:
        key = f"{p}hidden_states_norms.stage{stage + 1}"
        if f"{key}.weight" in sd:
            params[f"out_norm{stage}"] = _sd_layernorm(sd, key)
    return params


def bert_from_hf(sd: dict, num_layers: int, prefix: str = "") -> dict:
    """HF BertModel state dict -> the JAX Bert tree (the pooler unused)."""
    p = prefix
    params = {
        "word_embeddings": _t(sd[f"{p}embeddings.word_embeddings.weight"]),
        "position_embeddings": _t(sd[f"{p}embeddings.position_embeddings.weight"]),
        "token_type_embeddings": _t(sd[f"{p}embeddings.token_type_embeddings.weight"]),
        "embed_ln": _sd_layernorm(sd, f"{p}embeddings.LayerNorm"),
    }
    for i in range(num_layers):
        lp = f"{p}encoder.layer.{i}"
        params[f"layer{i}"] = {
            "q": _sd_dense(sd, f"{lp}.attention.self.query"),
            "k": _sd_dense(sd, f"{lp}.attention.self.key"),
            "v": _sd_dense(sd, f"{lp}.attention.self.value"),
            "attn_out": _sd_dense(sd, f"{lp}.attention.output.dense"),
            "attn_ln": _sd_layernorm(sd, f"{lp}.attention.output.LayerNorm"),
            "fc1": _sd_dense(sd, f"{lp}.intermediate.dense"),
            "fc2": _sd_dense(sd, f"{lp}.output.dense"),
            "out_ln": _sd_layernorm(sd, f"{lp}.output.LayerNorm"),
        }
    return params


def _gd_mha(sd, p):
    return {name: _sd_dense(sd, f"{p}.{src}")
            for name, src in (("q", "query"), ("k", "key"), ("v", "value"), ("out", "out_proj"))}


def _gd_msda(sd, p):
    return {name: _sd_dense(sd, f"{p}.{name}")
            for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj")}


def _gd_mlp_head(sd, p, n_layers=3):
    return {f"layer{i}": _sd_dense(sd, f"{p}.layers.{i}") for i in range(n_layers)}


def grounding_dino_from_hf(sd: dict, swin_depths, swin_out_stages, text_layers: int,
                           encoder_layers: int = 6, decoder_layers: int = 6,
                           num_backbone_levels: int = 3, num_levels: int = 4) -> dict:
    """HF GroundingDinoForObjectDetection state dict -> the JAX GroundingDino
    tree. The decoder's bbox_embed is tied to the top-level bbox_embed read
    here; position ids, relative-position indices and the BERT pooler are
    unused."""
    params: dict = {
        "backbone": swin_from_hf(sd, swin_depths, swin_out_stages, prefix="model.backbone.conv_encoder.model."),
        "text_backbone": bert_from_hf(sd, text_layers, prefix="model.text_backbone."),
        "text_projection": _sd_dense(sd, "model.text_projection"),
        "level_embed": _t(sd["model.level_embed"]),
        "query_embeds": _t(sd["model.query_position_embeddings.weight"]),
        "enc_output": _sd_dense(sd, "model.enc_output"),
        "enc_output_norm": _sd_layernorm(sd, "model.enc_output_norm"),
        "enc_bbox_head": _gd_mlp_head(sd, "model.encoder_output_bbox_embed"),
        "ref_point_head": _gd_mlp_head(sd, "model.decoder.reference_points_head", 2),
        "decoder_ln": _sd_layernorm(sd, "model.decoder.layer_norm"),
    }
    for i in range(num_levels):
        params[f"input_proj{i}"] = _sd_conv(sd, f"model.input_proj_vision.{i}.0")
        params[f"input_gn{i}"] = _sd_layernorm(sd, f"model.input_proj_vision.{i}.1")
    for i in range(encoder_layers):
        p = f"model.encoder.layers.{i}"
        fusion = f"{p}.fusion_layer"
        params[f"enc{i}"] = {
            "fusion_ln_v": _sd_layernorm(sd, f"{fusion}.layer_norm_vision"),
            "fusion_ln_t": _sd_layernorm(sd, f"{fusion}.layer_norm_text"),
            "fusion_attn": {name: _sd_dense(sd, f"{fusion}.attn.{name}")
                            for name in ("vision_proj", "text_proj", "values_vision_proj", "values_text_proj",
                                         "out_vision_proj", "out_text_proj")},
            "fusion_vision_scale": _t(sd[f"{fusion}.vision_param"]),
            "fusion_text_scale": _t(sd[f"{fusion}.text_param"]),
            "text_attn": _gd_mha(sd, f"{p}.text_enhancer_layer.self_attn"),
            "text_ln1": _sd_layernorm(sd, f"{p}.text_enhancer_layer.layer_norm_before"),
            "text_fc1": _sd_dense(sd, f"{p}.text_enhancer_layer.fc1"),
            "text_fc2": _sd_dense(sd, f"{p}.text_enhancer_layer.fc2"),
            "text_ln2": _sd_layernorm(sd, f"{p}.text_enhancer_layer.layer_norm_after"),
            "deform_attn": _gd_msda(sd, f"{p}.deformable_layer.self_attn"),
            "deform_ln1": _sd_layernorm(sd, f"{p}.deformable_layer.self_attn_layer_norm"),
            "deform_fc1": _sd_dense(sd, f"{p}.deformable_layer.fc1"),
            "deform_fc2": _sd_dense(sd, f"{p}.deformable_layer.fc2"),
            "deform_ln2": _sd_layernorm(sd, f"{p}.deformable_layer.final_layer_norm"),
        }
    for i in range(decoder_layers):
        p = f"model.decoder.layers.{i}"
        params[f"dec{i}"] = {
            "self_attn": _gd_mha(sd, f"{p}.self_attn"),
            "ln1": _sd_layernorm(sd, f"{p}.self_attn_layer_norm"),
            "text_cross": _gd_mha(sd, f"{p}.encoder_attn_text"),
            "ln2": _sd_layernorm(sd, f"{p}.encoder_attn_text_layer_norm"),
            "deform_cross": _gd_msda(sd, f"{p}.encoder_attn"),
            "ln3": _sd_layernorm(sd, f"{p}.encoder_attn_layer_norm"),
            "fc1": _sd_dense(sd, f"{p}.fc1"),
            "fc2": _sd_dense(sd, f"{p}.fc2"),
            "ln_out": _sd_layernorm(sd, f"{p}.final_layer_norm"),
        }
        params[f"dec_bbox{i}"] = _gd_mlp_head(sd, f"bbox_embed.{i}")
    return params


def zoedepth_from_hf(sd: dict, num_layers: int = 24, reassemble_factors=(4, 2, 1, 0.5)) -> dict:
    """HF ZoeDepthForDepthEstimation state dict (the single-domain ZoeD_N
    layout, Intel/zoedepth-nyu) -> the JAX ZoeDepthModel tree: the BEiT
    backbone with per-layer relative-position tables (stacked [L, ...] as the
    JAX model scans them), the DPT reassemble and fusion neck, the relative
    head and the metric-bins head. Fusion layer 0's residual_layer1 is in the
    checkpoint but has no skip input to act on, and is skipped."""
    layers = []
    for i in range(num_layers):
        p = f"backbone.encoder.layer.{i}"
        att = f"{p}.attention.attention"
        layers.append({"block": {
            "rel_pos_table": _t(sd[f"{att}.relative_position_bias.relative_position_bias_table"]),
            "ln1": _sd_layernorm(sd, f"{p}.layernorm_before"),
            "ln2": _sd_layernorm(sd, f"{p}.layernorm_after"),
            "q": _sd_dense(sd, f"{att}.query"),
            "k": {"kernel": _t(sd[f"{att}.key.weight"]).T},
            "v": _sd_dense(sd, f"{att}.value"),
            "proj": _sd_dense(sd, f"{p}.attention.output.dense"),
            "fc1": _sd_dense(sd, f"{p}.intermediate.dense"),
            "fc2": _sd_dense(sd, f"{p}.output.dense"),
            "lambda_1": _t(sd[f"{p}.lambda_1"]),
            "lambda_2": _t(sd[f"{p}.lambda_2"]),
        }})
    params: dict = {"backbone": {
        "patch_embed": _sd_conv(sd, "backbone.embeddings.patch_embeddings.projection"),
        "cls_token": _t(sd["backbone.embeddings.cls_token"]),
        "blocks": _stack_trees(layers),
    }}

    rs = "neck.reassemble_stage"
    reassemble: dict = {}
    for i, factor in enumerate(reassemble_factors):
        reassemble[f"readout{i}"] = _sd_dense(sd, f"{rs}.readout_projects.{i}.0")
        reassemble[f"proj{i}"] = _sd_conv(sd, f"{rs}.layers.{i}.projection")
        if factor > 1:  # a ConvTranspose2d: its torch layout in both trees
            reassemble[f"resize{i}_w"] = _t(sd[f"{rs}.layers.{i}.resize.weight"])
            reassemble[f"resize{i}_b"] = _t(sd[f"{rs}.layers.{i}.resize.bias"])
        elif factor < 1:
            reassemble[f"resize{i}"] = _sd_conv(sd, f"{rs}.layers.{i}.resize")
    params["reassemble"] = reassemble
    for i in range(4):
        params[f"neck_conv{i}"] = _sd_conv(sd, f"neck.convs.{i}", bias=False)

    def two_convs(p):
        return {"conv1": _sd_conv(sd, f"{p}.conv1"), "conv2": _sd_conv(sd, f"{p}.conv2")}

    for i in range(4):
        p = f"neck.fusion_stage.layers.{i}"
        layer = {"proj": _sd_conv(sd, f"{p}.projection"),
                 "res2": {"conv1": _sd_conv(sd, f"{p}.residual_layer2.convolution1"),
                          "conv2": _sd_conv(sd, f"{p}.residual_layer2.convolution2")}}
        if i > 0:
            layer["res1"] = {"conv1": _sd_conv(sd, f"{p}.residual_layer1.convolution1"),
                             "conv2": _sd_conv(sd, f"{p}.residual_layer1.convolution2")}
        params[f"fusion{i}"] = layer

    for i in (1, 2, 3):
        params[f"rel_conv{i}"] = _sd_conv(sd, f"relative_head.conv{i}")
    mh = "metric_head"
    params["mh_conv2"] = _sd_conv(sd, f"{mh}.conv2")
    params["seed_bin"] = two_convs(f"{mh}.seed_bin_regressor")
    params["seed_proj"] = two_convs(f"{mh}.seed_projector")
    for i in range(4):
        params[f"mh_proj{i}"] = two_convs(f"{mh}.projectors.{i}")
        params[f"attractor{i}"] = two_convs(f"{mh}.attractors.{i}")
    params["clb"] = {"mlp1": _sd_conv(sd, f"{mh}.conditional_log_binomial.mlp.0"),
                     "mlp2": _sd_conv(sd, f"{mh}.conditional_log_binomial.mlp.2")}
    return params


def cotracker2_from_hub(sd: dict, depth: int = 6) -> dict:
    """facebookresearch/co-tracker `cotracker2` torch.hub state dict -> the
    JAX CoTracker2 tree (`cotracker2_to_jax` of its first `depth` layers).
    Names may carry a "model." prefix; the released code spells the virtual
    tracks "virual_tracks", and "virtual_tracks" is read too. Instance norms
    and the affine-free pre-norms carry no parameters; the time and position
    embeddings are recomputed."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    if "updateformer.virual_tracks" not in sd:
        sd["updateformer.virual_tracks"] = sd["updateformer.virtual_tracks"]
    return cotracker2_to_jax(sd, depth)
