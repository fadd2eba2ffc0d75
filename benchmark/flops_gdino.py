"""GroundingDINO-B's work per image, from the configuration's shapes and the
program's counters: the frozen arithmetic behind `gdino_roofline.bop`,
`gdino_deform_roofline.bop` and the detector's part of `mfu.bop`.

As benchmark/flops.py counts: a multiply-add is 2 operations; matrix
products, convolutions and attention count, norms and other elementwise
work do not. Swin's window attention and its qkv and output projections run
on the grid padded up to whole windows, as the program computes them. A
deformable sample is its four bilinear taps of one head's channels, each a
multiply-add, and the attention weight (2·(4 + 1)·head_dim operations).
Bytes count each input of a product read once and each output written
once, at the served width (2 bytes), its weights once per image; a sample
reads its four taps' head channels."""
from __future__ import annotations

from benchmark.flops import BF16, attention, attention_bytes, conv

PROMPT_TOKENS = 4  # the placeholder prompt of "objects."


def _linear(n: int, d_in: int, d_out: int, item: int = BF16) -> tuple[float, float]:
    return 2.0 * n * d_in * d_out, float((n * d_in + n * d_out + d_in * d_out) * item)


def _add(*parts: tuple[float, float]) -> tuple[float, float]:
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def _pad(n: int, w: int) -> int:
    return -(-n // w) * w


def swin(g: dict) -> tuple[float, float]:
    """Swin over the square image: patch embedding, blocks, merging."""
    s = g["swin"]
    size = g["image_size"] // s["patch_size"]
    ws = s["window_size"]
    c0 = s["embed_dim"]
    parts = [(conv(size, size, 3, c0, s["patch_size"]), float((3 * g["image_size"] ** 2 + size * size * c0) * BF16))]
    h = size
    for stage, depth in enumerate(s["depths"]):
        c = c0 * 2 ** stage
        hp = _pad(h, ws)
        n, npad = h * h, hp * hp
        hidden = int(c * s["mlp_ratio"])
        for _ in range(depth):
            windows = npad // (ws * ws)
            parts += [_linear(npad, c, 3 * c), _linear(npad, c, c), _linear(n, c, hidden), _linear(n, hidden, c),
                      (windows * attention(ws * ws, ws * ws, c), windows * attention_bytes(ws * ws, ws * ws, c))]
        if stage + 1 < len(s["depths"]):
            h = -(-h // 2)
            parts.append(_linear(h * h, 4 * c, 2 * c))
    return _add(*parts)


def stage_sides(g: dict) -> list[int]:
    """The side of each feature level's square map."""
    s = g["swin"]
    h = g["image_size"] // s["patch_size"]
    sides = []
    for stage in range(len(s["depths"])):
        if stage in s["out_stages"]:
            sides.append(h)
        h = -(-h // 2)
    while len(sides) < g["transformer"]["num_feature_levels"]:
        sides.append(-(-sides[-1] // 2))
    return sides


def bert(g: dict, t: int = PROMPT_TOKENS) -> tuple[float, float]:
    b = g["text"]
    h, inter = b["hidden_size"], b["intermediate"]
    layer = _add(_linear(t, h, 3 * h), _linear(t, h, h), _linear(t, h, inter), _linear(t, inter, h),
                 (attention(t, t, h), attention_bytes(t, t, h)))
    return layer[0] * b["num_layers"], layer[1] * b["num_layers"]


def input_projections(g: dict) -> tuple[float, float]:
    s, d = g["swin"], g["transformer"]["d_model"]
    sides = stage_sides(g)
    dims = [s["embed_dim"] * 2 ** i for i in s["out_stages"]]
    parts = [_linear(sides[i] ** 2, dims[i], d) for i in range(len(dims))]
    src = dims[-1]
    for side in sides[len(dims):]:
        parts.append((conv(side, side, src, d, 3), float((side * side * (9 * src + d) + 9 * src * d) * BF16)))
        src = d
    return _add(*parts)


def deform(t: dict, n_q: int, n_v: int, heads: int, points: int) -> tuple[float, float]:
    """One deformable attention's projections: the value projection of n_v
    positions, the offsets, weights and output projection of n_q queries."""
    d = t["d_model"]
    per = heads * t["num_feature_levels"] * points
    return _add(_linear(n_v, d, d), _linear(n_q, d, 2 * per), _linear(n_q, d, per), _linear(n_q, d, d))


def samples(t: dict, n: int) -> tuple[float, float]:
    """`n` deformable samples of one head's channels each: four taps and
    the weight; reads the taps, the location and the weight, writes the
    sum."""
    hd = t["d_model"] // t["encoder_heads"]
    return 2.0 * 5 * hd * n, float(n * (4 * hd + 3) * BF16)


def encoder_layer(t: dict, s: int, text: int) -> tuple[float, float]:
    """One encoder layer on s positions, its deformable sampling excepted."""
    d, ffn = t["d_model"], t["encoder_ffn"]
    e = ffn // 2
    fusion = _add(_linear(s, d, e), _linear(s, d, e), _linear(s, e, d), _linear(text, d, e), _linear(text, d, e),
                  _linear(text, e, d), (2 * attention(s, text, e), 2 * attention_bytes(s, text, e)))
    text_layer = _add(_linear(text, d, 3 * d), _linear(text, d, d), (attention(text, text, d),
                                                                      attention_bytes(text, text, d)),
                      _linear(text, d, e), _linear(text, e, d))
    return _add(fusion, text_layer, _linear(s, d, ffn), _linear(s, ffn, d))


def select(t: dict, s: int, text: int) -> tuple[float, float]:
    d = t["d_model"]
    return _add(_linear(s, d, d), _linear(s, d, text), _linear(s, d, d), _linear(s, d, d), _linear(s, d, 4))


def decoder_layer(t: dict, q: int, text: int) -> tuple[float, float]:
    """One decoder layer on q queries, its deformable attention excepted,
    with its query position head and its box head."""
    d, ffn = t["d_model"], t["decoder_ffn"]
    return _add(_linear(q, d, 3 * d), _linear(q, d, d), (attention(q, q, d), attention_bytes(q, q, d)),
                _linear(q, d, d), _linear(text, d, 2 * d), _linear(q, d, d),
                (attention(q, text, d), attention_bytes(q, text, d)),
                _linear(q, d, ffn), _linear(q, ffn, d),
                _linear(q, 2 * d, d), _linear(q, d, d), _linear(q, d, d), _linear(q, d, d), _linear(q, d, 4))


def work(cfg: dict, images: int, tokens: int, queries: int, samples_enc: int, samples_dec: int) -> dict:
    """The detector's work over a traced window, from the program's
    counters (`gdino.images`, `.tokens`, `.queries`,
    `.deform_samples.encoder` / `.decoder`): {"total": (ops, bytes), the
    whole forward; "deform": (ops, bytes), the deformable attentions}."""
    g = cfg["grounding_dino"]
    t = g["transformer"]
    if not images:
        return {"total": (0.0, 0.0), "deform": (0.0, 0.0)}
    s, q = tokens // images, queries // images
    per_image = _add(swin(g), bert(g), _linear(PROMPT_TOKENS, g["text"]["hidden_size"], t["d_model"]),
                     input_projections(g),
                     *[encoder_layer(t, s, PROMPT_TOKENS)] * t["encoder_layers"],
                     select(t, s, PROMPT_TOKENS),
                     *[decoder_layer(t, q, PROMPT_TOKENS)] * t["decoder_layers"],
                     _linear(q, t["d_model"], PROMPT_TOKENS))
    enc = deform(t, s, s, t["encoder_heads"], t["encoder_points"])
    dec = deform(t, q, s, t["decoder_heads"], t["decoder_points"])
    sample_ops = samples(t, samples_enc + samples_dec)
    deform_total = (images * (t["encoder_layers"] * enc[0] + t["decoder_layers"] * dec[0]) + sample_ops[0],
                    images * (t["encoder_layers"] * enc[1] + t["decoder_layers"] * dec[1]) + sample_ops[1])
    total = (images * per_image[0] + deform_total[0], images * per_image[1] + deform_total[1])
    return {"total": total, "deform": deform_total}


def image_ops(cfg: dict) -> float:
    """The operations of one image's forward at the configured size."""
    g = cfg["grounding_dino"]
    t = g["transformer"]
    s = sum(side * side for side in stage_sides(g))
    per = t["encoder_heads"] * t["num_feature_levels"] * t["encoder_points"]
    return work(cfg, 1, s, t["num_queries"], s * per * t["encoder_layers"],
                t["num_queries"] * per * t["decoder_layers"])["total"][0]
