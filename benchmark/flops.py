"""The work of each operation, from the configuration's shapes alone: the
frozen arithmetic behind every roofline and `mfu` metric. A multiply-add
counts 2 operations; only matrix products, convolutions and attention are
counted (norms, activations and other elementwise work are left out).
Bytes count each input read once and each output written once, at the
served dtype's width."""
from __future__ import annotations

BF16 = 2


def attention(n_q: int, n_k: int, width: int) -> float:
    """softmax(q·kᵀ)·v over `width` = heads × head dim: q·kᵀ and p·v."""
    return 4.0 * n_q * n_k * width


def attention_bytes(n_q: int, n_k: int, width: int, item: int = BF16) -> float:
    """q and the output [n_q, width], k and v [n_k, width]."""
    return float(2 * (n_q + n_k) * width * item)


def linear(n: int, d_in: int, d_out: int) -> float:
    return 2.0 * n * d_in * d_out


def conv(h_out: int, w_out: int, c_in: int, c_out: int, k: int, groups: int = 1) -> float:
    return 2.0 * h_out * w_out * (c_in // groups) * k * k * c_out


# ---------------------------------------------------------------- DINOv2
def vit_tokens(vit: dict, res: int) -> int:
    g = res // vit["patch_size"]
    return g * g + 1 + vit["num_registers"]


def vit_layer(vit: dict, n: int) -> dict:
    """One pre-norm ViT block on n tokens: qkv, attention, proj, MLP."""
    d, hid = vit["hidden_size"], int(vit["hidden_size"] * vit["mlp_ratio"])
    mm = linear(n, d, 3 * d) + linear(n, d, d) + linear(n, d, hid) + linear(n, hid, d)
    return {"matmul": mm, "attention": attention(n, n, d), "attention_bytes": attention_bytes(n, n, d)}


def vit_image(vit: dict, res: int, layers: int) -> dict:
    """One image through the patch embedding and `layers` blocks."""
    n = vit_tokens(vit, res)
    g = res // vit["patch_size"]
    layer = vit_layer(vit, n)
    patch = conv(g, g, 3, vit["hidden_size"], vit["patch_size"])
    return {"total": patch + layers * (layer["matmul"] + layer["attention"]),
            "attention": layers * layer["attention"], "attention_bytes": layers * layer["attention_bytes"]}


# ---------------------------------------------------------------- SAM2
def hiera_blocks(sam2: dict) -> list[dict]:
    """Each Hiera block's work at the configured image size: its stage,
    tokens in and out, dims in and out, key tokens per query and whether its
    attention is global."""
    h = sam2["hiera"]
    side = sam2["image_size"] // 4  # the patch embedding's stride
    out, total = [], 0
    for stage, n_blocks in enumerate(h["blocks_per_stage"]):
        for i in range(n_blocks):
            first = stage > 0 and i == 0
            d_in = h["embed_dim_per_stage"][stage - 1] if first else h["embed_dim_per_stage"][stage]
            d_out = h["embed_dim_per_stage"][stage]
            ws = h["window_size_per_stage"][stage - 1] if first else h["window_size_per_stage"][stage]
            glob = total in h["global_attention_blocks"]
            stride = h["query_stride"] if first and stage <= h["num_query_pool_stages"] else 1
            side_out = side // stride
            n_in, n_out = side * side, side_out * side_out
            keys = n_in if glob else ws * ws
            out.append({"block": total, "stage": stage, "n_in": n_in, "n_out": n_out, "d_in": d_in,
                        "d_out": d_out, "keys": keys, "global": glob})
            side = side_out
            total += 1
    return out


def hiera_block(b: dict, mlp_ratio: float) -> dict:
    hid = int(b["d_out"] * mlp_ratio)
    mm = linear(b["n_in"], b["d_in"], 3 * b["d_out"]) + linear(b["n_out"], b["d_out"], b["d_out"])
    mm += linear(b["n_out"], b["d_out"], hid) + linear(b["n_out"], hid, b["d_out"])
    if b["d_in"] != b["d_out"]:
        mm += linear(b["n_in"], b["d_in"], b["d_out"])  # the residual's projection
    return {"matmul": mm, "attention": attention(b["n_out"], b["keys"], b["d_out"])}


def hiera(sam2: dict) -> dict:
    """The trunk: patch embedding, then every block -> total, per stage, and
    the global blocks' attention with its bytes."""
    h = sam2["hiera"]
    side = sam2["image_size"] // 4
    total = conv(side, side, 3, h["embed_dim"], 7)
    stages = [0.0] * len(h["blocks_per_stage"])
    glob, glob_bytes = 0.0, 0.0
    for b in hiera_blocks(sam2):
        w = hiera_block(b, h["mlp_ratio"])
        stages[b["stage"]] += w["matmul"] + w["attention"]
        if b["global"]:
            glob += w["attention"]
            glob_bytes += attention_bytes(b["n_out"], b["keys"], b["d_out"])
    return {"total": total + sum(stages), "stages": stages, "global_attention": glob,
            "global_attention_bytes": glob_bytes}


def neck(sam2: dict) -> float:
    """The FPN's lateral 1x1 convolutions and the two SAM-head projections."""
    side, fpn = sam2["image_size"] // 4, sam2["fpn_dim"]
    total = 0.0
    for stage, dim in enumerate(sam2["hiera"]["embed_dim_per_stage"]):
        s = side >> stage
        total += conv(s, s, dim, fpn, 1)
    hid = sam2["decoder"]["hidden_size"]
    return total + conv(side, side, fpn, hid // 8, 1) + conv(side // 2, side // 2, fpn, hid // 4, 1)


def memory_keys(sam2: dict, t: int) -> tuple[int, int]:
    """(memory tokens, pointer tokens) valid at frame t of a video prompted
    at frame 0: the conditioning frame and up to num_maskmem - 1 recent
    frames; the conditioning pointer and up to max_obj_ptrs - 1 recent ones,
    each split into hidden / mem_dim tokens."""
    m = sam2["memory"]
    if t == 0:
        return 0, 0
    hw = sam2["mem_grid"] ** 2
    frames = 1 + min(t - 1, m["num_maskmem"] - 1)
    ptrs = 1 + min(t - 1, m["max_obj_ptrs"] - 1)
    return frames * hw, ptrs * (m["hidden_size"] // m["mem_dim"])


def memory_attention(sam2: dict, t: int) -> dict:
    """The 4 memory-attention layers at frame t (none on the prompt frame):
    self-attention over the frame's tokens, cross-attention over the valid
    memory and pointer tokens, the MLP."""
    m = sam2["memory"]
    n, d = sam2["mem_grid"] ** 2, m["hidden_size"]
    mem, ptr = memory_keys(sam2, t)
    if mem == 0:
        return {"total": 0.0, "self": 0.0, "cross": 0.0, "self_bytes": 0.0, "cross_bytes": 0.0}
    keys = mem + ptr
    per_layer_mm = 4 * linear(n, d, d) + linear(n, d, d) * 2 + 2 * linear(keys, m["mem_dim"], d)
    per_layer_mm += linear(n, d, m["ff_hidden"]) + linear(n, m["ff_hidden"], d)
    self_attn, cross = attention(n, n, d), attention(n, keys, d)
    layers = m["num_layers"]
    return {"total": layers * (per_layer_mm + self_attn + cross), "self": layers * self_attn,
            "cross": layers * cross, "self_bytes": layers * attention_bytes(n, n, d),
            "cross_bytes": layers * attention_bytes(n, keys, d)}


def memory_encoder(sam2: dict) -> float:
    m = sam2["memory"]
    side, ch, total = sam2["image_size"], 1, 0.0
    while side > sam2["mem_grid"]:
        side //= 2
        total += conv(side, side, ch, ch * 4, 3)
        ch *= 4
    g = sam2["mem_grid"]
    total += conv(g, g, ch, m["enc_hidden"], 1) + conv(g, g, sam2["fpn_dim"], m["enc_hidden"], 1)
    for _ in range(m["fuser_layers"]):
        total += conv(g, g, m["enc_hidden"], m["enc_hidden"], m["fuser_kernel"], groups=m["enc_hidden"])
        total += linear(g * g, m["enc_hidden"], m["fuser_intermediate"]) * 2
    return total + conv(g, g, m["enc_hidden"], m["mem_dim"], 1)


def mask_decoder(sam2: dict, tokens: int = 16) -> float:
    """The two-way transformer's products over the image tokens (the
    prompt tokens' own are negligible), the upscaling and the masks."""
    c = sam2["decoder"]
    d, g = c["hidden_size"], sam2["mem_grid"]
    n, inner = g * g, d // 2
    per_block = 2 * linear(n, d, inner) + linear(n, d, inner) + linear(n, inner, d)
    per_block += 2 * attention(tokens, n, inner) + linear(tokens, d, c["mlp_dim"]) * 2
    total = 2 * per_block + 2 * linear(n, d, inner) + attention(tokens, n, inner)
    # The 2x2 stride-2 transposed convolutions: each output pixel reads one
    # input pixel's channels.
    total += conv(2 * g, 2 * g, d, d // 4, 1) + conv(4 * g, 4 * g, d // 4, d // 8, 1)
    return total + 2.0 * 4 * (4 * g) ** 2 * (d // 8)


def sam2_frame(sam2: dict, t: int) -> dict:
    """One object's SAM2 step at frame t: trunk, neck, memory attention (not
    on the prompt frame), decoder, memory encoder; with the attention the
    port's K2 d 72 / d 256 and K4 carry, and their bytes."""
    tr, ma = hiera(sam2), memory_attention(sam2, t)
    total = tr["total"] + neck(sam2) + ma["total"] + mask_decoder(sam2) + memory_encoder(sam2)
    return {"total": total, "attention": tr["global_attention"] + ma["self"] + ma["cross"],
            "attention_bytes": tr["global_attention_bytes"] + ma["self_bytes"] + ma["cross_bytes"]}


def video_frame(cfg: dict, t: int, views_featurized: int) -> float:
    """The coupled video step's operations at frame t: SAM2, DINOv2-L on the
    query crop and on the `views_featurized` fine views it rendered, and
    StreamingInliers' two DINOv2-B images (photo and render)."""
    r = cfg["refine"]
    lv = vit_image(cfg["dinov2_l"], r["template_res"], r["feature_layer"])["total"]
    bv = vit_image(cfg["dinov2_b"], cfg["inliers"]["res"], cfg["dinov2_b"]["num_layers"])["total"]
    return sam2_frame(cfg["sam2"], t)["total"] + (1 + views_featurized) * lv + 2 * bv

