"""SAM2 modules of the PyTorch port vs the JAX package, on the CPU.

One seeded parameter tree in the JAX layout (models/convert.py:
random_jax_params / random_sam2_video_params) goes into the JAX modules as
it is and into the port's modules through sam2_video_from_jax; the inputs
are seeded numpy arrays. Tolerances (fp32): 1e-4 absolute on features and
logits of O(1) to O(10) (the same fp32 arithmetic summed in another order);
binarised masks agree on at least 99.5% of pixels. Where the JAX modules
reach a Pallas kernel (global Hiera attention, memory attention), they run
it in interpret mode through the JAX package's FORCE_INTERPRET switch. The
JAX references run under jax.jit: one compile per call site instead of
op-by-op eager dispatch, which took most of this file's time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import freepose_tpu.ops.attention as jax_attention
from freepose_tpu.models.sam2 import hiera as jhiera
from freepose_tpu.models.sam2 import mask_decoder as jdecoder
from freepose_tpu.models.sam2 import memory as jmemory
from freepose_tpu.models.sam2 import model as jmodel
from freepose_tpu.models.sam2 import prompt as jprompt
from freepose_tpu.models.sam2 import video as jvideo
from freepose_tpu_torch.models.convert import random_jax_params, random_sam2_video_params, sam2_video_from_jax
from freepose_tpu_torch.models.sam2.hiera import HIERA_TEST, Hiera
from freepose_tpu_torch.models.sam2.mask_decoder import MaskDecoder
from freepose_tpu_torch.models.sam2.memory import MemoryAttention, MemoryEncoder, rope_2d_cos_sin
from freepose_tpu_torch.models.sam2.model import Sam2ImageModel
from freepose_tpu_torch.models.sam2.predictor import prepare_image
from freepose_tpu_torch.models.sam2.prompt import PromptEncoder
from freepose_tpu_torch.models.sam2.video import Sam2VideoModel, init_object_state
from freepose_tpu_torch.scripts.common import tiny_sam2_video_config

ATOL = 1e-4
CFG = tiny_sam2_video_config()


def _jax_cfg(cfg):
    """The JAX package's dataclasses with the port config's field values."""
    s, m = cfg.sam, cfg.mem
    drop = ("dtype",)
    fields = lambda obj: {k: v for k, v in dataclasses.asdict(obj).items() if k not in drop}  # noqa: E731
    sam = jmodel.Sam2Config(hiera=jhiera.HieraConfig(**fields(s.hiera)), prompt=jprompt.PromptConfig(**fields(s.prompt)),
                            decoder=jdecoder.MaskDecoderConfig(**fields(s.decoder)), fpn_dim=s.fpn_dim)
    return jvideo.Sam2VideoConfig(sam=sam, mem=jmemory.MemoryConfig(**fields(m)), image_size=cfg.image_size,
                                  mem_grid=cfg.mem_grid)


JCFG = _jax_cfg(CFG)


@pytest.fixture(scope="module")
def params():
    return random_sam2_video_params(CFG, seed=0)


@pytest.fixture
def interpret():
    old = jax_attention.FORCE_INTERPRET
    jax_attention.FORCE_INTERPRET = True
    yield
    jax_attention.FORCE_INTERPRET = old


def _load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    module.load_state_dict(sam2_video_from_jax(tree))
    return module.eval().requires_grad_(False)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _japply(module, tree: dict, *args, method=None, **static):
    """`module.apply({"params": tree}, *args, method=method, **static)` under
    jax.jit; the positional arguments are traced, the keywords static."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=method, **static))(tree, *args)


def test_hiera_with_global_block_matches_jax(interpret):
    cfg = dataclasses.replace(HIERA_TEST, use_flash=True)
    tree = random_jax_params(Hiera(cfg), seed=1)
    pixels = np.random.default_rng(0).normal(size=(1, 3, 64, 64)).astype(np.float32)
    ref = _japply(jhiera.Hiera(jhiera.HieraConfig(**{**dataclasses.asdict(cfg), "dtype": jnp.float32})), tree,
                  jnp.asarray(pixels))
    with torch.no_grad():
        ours = _load(Hiera(cfg), tree)(_t(pixels))
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_prompt_encoder_matches_jax(params):
    tree = params["image"]["prompt_encoder"]
    rng = np.random.default_rng(2)
    points = (rng.random((2, 1, 3, 2)) * 64).astype(np.float32)
    labels = np.array([[[1, 0, -10]], [[1, -1, 1]]], np.int32)
    boxes = np.array([[[4.0, 6.0, 40.0, 50.0]], [[10.0, 3.0, 60.0, 33.0]]], np.float32)
    masks = rng.normal(size=(2, 1, 16, 16)).astype(np.float32)
    jmod = jprompt.PromptEncoder(JCFG.sam.prompt)
    ours_mod = _load(PromptEncoder(CFG.sam.prompt), tree)
    for args in ((points, labels, None, None), (None, None, boxes, masks), (points, labels, boxes, None)):
        jsparse, jdense = _japply(jmod, tree, *(None if a is None else jnp.asarray(a) for a in args))
        with torch.no_grad():
            sparse, dense = ours_mod(*(None if a is None else _t(a) for a in args))
        np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse), atol=ATOL)
        np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=ATOL)
    pe = _japply(jmod, tree, method=jprompt.PromptEncoder.image_wide_pe)
    np.testing.assert_allclose(ours_mod.image_wide_pe().detach().numpy(), np.asarray(pe), atol=ATOL)


@pytest.mark.parametrize("multimask", [True, False])
def test_image_model_decode_matches_jax(params, multimask):
    tree = params["image"]
    rng = np.random.default_rng(3)
    pixels = rng.normal(size=(1, 3, 64, 64)).astype(np.float32)
    boxes = np.array([[[5.0, 8.0, 40.0, 52.0], [20.0, 2.0, 63.0, 30.0]]], np.float32)
    jm = jmodel.Sam2ImageModel(JCFG.sam)
    ref = jax.jit(lambda p, x, b: jm.apply({"params": p}, x, boxes=b, multimask_output=multimask))(
        tree, jnp.asarray(pixels), jnp.asarray(boxes))
    with torch.no_grad():
        ours = _load(Sam2ImageModel(CFG.sam), tree)(_t(pixels), boxes=_t(boxes), multimask_output=multimask)
    for o, r in zip(ours, ref):  # masks, iou, sam tokens, object logits
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_jax(params, multimask):
    """Two images, two prompts each, with the high-resolution skip features."""
    tree = params["image"]["decoder"]
    d, g = CFG.sam.fpn_dim, CFG.image_size // 16
    rng = np.random.default_rng(8)
    args = [rng.normal(size=s).astype(np.float32) for s in
            ((2, g, g, d), (g, g, d), (2, 2, 3, d), (2, g, g, d), (2, 4 * g, 4 * g, d // 8), (2, 2 * g, 2 * g, d // 4))]
    ref = jax.jit(lambda p, a, hr: jdecoder.MaskDecoder(JCFG.sam.decoder).apply({"params": p}, *a, hr, multimask))(
        tree, tuple(map(jnp.asarray, args[:4])), tuple(map(jnp.asarray, args[4:])))
    with torch.no_grad():
        ours = _load(MaskDecoder(CFG.sam.decoder), tree)(*map(_t, args[:4]), tuple(map(_t, args[4:])), multimask)
    for o, r in zip(ours, ref):  # masks, iou, sam tokens, object logits
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def _memory_inputs(seed=4, b=2):
    m, hw = CFG.mem, CFG.mem_grid**2
    n_ptr = m.max_obj_ptrs * (m.hidden_size // m.mem_dim)
    rng = np.random.default_rng(seed)
    curr = rng.normal(size=(b, hw, m.hidden_size)).astype(np.float32)
    curr_pos = rng.normal(size=(b, hw, m.hidden_size)).astype(np.float32)
    memory = rng.normal(size=(b, m.num_maskmem * hw + n_ptr, m.mem_dim)).astype(np.float32)
    memory_pos = rng.normal(size=memory.shape).astype(np.float32)
    slots = np.zeros((b, m.num_maskmem), bool)
    slots[:, 0] = True
    slots[0, 1:3] = True  # object 0: three slots; object 1: the conditioning slot alone
    ptrs = np.zeros((b, m.max_obj_ptrs), bool)
    ptrs[:, :2] = True
    kv_mask = np.concatenate([np.repeat(slots, hw, 1), np.repeat(ptrs, m.hidden_size // m.mem_dim, 1)], 1)
    return curr, curr_pos, memory, memory_pos, n_ptr, kv_mask


@pytest.mark.parametrize("use_flash", [False, True])
def test_memory_attention_matches_jax(params, interpret, use_flash):
    """Masked slots and pointer tokens excluded from RoPE; with use_flash the
    JAX side runs the Pallas kernels K2 (self) and K4 (cross) in interpret
    mode and the port their plain versions."""
    tree = params["memory_attention"]
    curr, curr_pos, memory, memory_pos, n_ptr, kv_mask = _memory_inputs()
    jcfg = dataclasses.replace(JCFG.mem, use_flash=use_flash)
    ref = jax.jit(lambda p, a, m: jmemory.MemoryAttention(jcfg).apply({"params": p}, *a, n_ptr, m))(
        tree, tuple(map(jnp.asarray, (curr, curr_pos, memory, memory_pos))), jnp.asarray(kv_mask))
    with torch.no_grad():
        ours = _load(MemoryAttention(dataclasses.replace(CFG.mem, use_flash=use_flash)), tree)(
            *map(_t, (curr, curr_pos, memory, memory_pos)), n_ptr, _t(kv_mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_rope_tables_and_pointer_exclusion_match_jax():
    cos, sin = rope_2d_cos_sin(16, 4)
    jcos, jsin = jmemory.rope_2d_cos_sin(16, 4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    from freepose_tpu_torch.models.sam2.memory import apply_rope_2d

    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 1, 16, 16)).astype(np.float32)
    k = rng.normal(size=(2, 1, 3 * 16 + 5, 16)).astype(np.float32)
    jq, jk = jmemory.apply_rope_2d(jnp.asarray(q), jnp.asarray(k), jcos, jsin, num_k_exclude=5, repeat_freqs_k=True)
    oq, ok = apply_rope_2d(_t(q), _t(k), cos, sin, num_k_exclude=5, repeat_freqs_k=True)
    np.testing.assert_allclose(oq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(ok.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_array_equal(ok[..., -5:, :].numpy(), k[..., -5:, :])  # pointers not rotated


def test_memory_encoder_matches_jax(params):
    tree = params["memory_encoder"]
    rng = np.random.default_rng(6)
    pix = rng.normal(size=(2, 4, 4, CFG.sam.fpn_dim)).astype(np.float32)
    masks = (rng.normal(size=(2, 64, 64, 1)) * 10).astype(np.float32)
    jfeats, jpos = _japply(jmemory.MemoryEncoder(JCFG.mem), tree, jnp.asarray(pix), jnp.asarray(masks))
    with torch.no_grad():
        feats, pos = _load(MemoryEncoder(CFG.mem, in_dim=CFG.sam.fpn_dim), tree)(_t(pix), _t(masks))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-6)


def test_three_track_steps_with_a_box_prompt_match_jax(params):
    """Frame 0 conditions on a box (2 corner points, padded to the prompt
    cap); frames 1 and 2 read the memory. Masks, pointers, object scores and
    the written memory agree."""
    rng = np.random.default_rng(7)
    video = rng.normal(size=(3, 1, 3, 64, 64)).astype(np.float32) * 0.5
    cap = CFG.max_point_prompts
    pts = np.zeros((1, 1, cap, 2), np.float32)
    pts[0, 0, :2] = [[8.0, 10.0], [44.0, 50.0]]
    lbl = np.full((1, 1, cap), -10, np.int32)
    lbl[0, 0, :2] = [2, 3]

    jm = jvideo.Sam2VideoModel(JCFG)
    embed = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jvideo.Sam2VideoModel.embed_frame))
    step = jax.jit(lambda p, *a, **kw: jm.apply({"params": p}, *a, method=jvideo.Sam2VideoModel.track_step, **kw),
                   static_argnames=("is_init",))
    jstate = jvideo.init_object_state(JCFG)
    model = _load(Sam2VideoModel(CFG), params)
    state = init_object_state(CFG)
    for t in range(3):
        pyramid, pos = embed(params, jnp.asarray(video[t]))
        kw = dict(frame_idx=jnp.int32(t), num_frames=jnp.int32(3))
        if t == 0:
            kw.update(points=jnp.asarray(pts), labels=jnp.asarray(lbl), is_init=True)
        jstate, jout = step(params, jstate, pyramid, pyramid[2], pos[2], **kw)
        with torch.no_grad():
            tpyr, tpos = model.embed_frame(_t(video[t]))
            extra = dict(points=_t(pts)[0][None], labels=_t(lbl).long()[0][None], is_init=True) if t == 0 else {}
            state, out = model.track_step(state, tpyr, tpyr[2], tpos[2], t, 3, **extra)
        for name in ("pred_masks", "high_res_masks", "object_pointer", "object_score_logits", "iou_scores"):
            np.testing.assert_allclose(out[name].numpy(), np.asarray(jout[name]), atol=ATOL, err_msg=f"{name}, frame {t}")
        agree = np.mean((out["high_res_masks"].numpy() > 0) == (np.asarray(jout["high_res_masks"]) > 0))
        assert agree >= 0.995, f"frame {t}: binary agreement {agree}"
        np.testing.assert_allclose(state.maskmem[0].numpy(), np.asarray(jstate.maskmem), atol=ATOL)
        np.testing.assert_array_equal(state.maskmem_valid[0].numpy(), np.asarray(jstate.maskmem_valid))
        np.testing.assert_array_equal(state.ptr_frame[0].numpy(), np.asarray(jstate.ptr_frame))
        assert state.ring_pos == int(jstate.ring_pos) and state.ptr_ring_pos == int(jstate.ptr_ring_pos)


@pytest.mark.parametrize("use_flash", [False, True])
def test_embed_frame_on_a_stack_equals_the_frames_one_by_one(params, use_flash):
    """The video predictor embeds a propagation batch's frames in one trunk
    call: prepare_image on [K, H, W, 3] equals it frame by frame, and
    embed_frame on the stack (with a global block, on flash_attention's
    plain version or the einsum) equals the frames' batch-of-one calls
    within 1e-5: the same fp32 arithmetic, sums blocked differently at
    batch K."""
    hiera = dataclasses.replace(CFG.sam.hiera, global_attention_blocks=(2,), use_flash=use_flash)
    cfg = dataclasses.replace(CFG, sam=dataclasses.replace(CFG.sam, hiera=hiera))
    model = _load(Sam2VideoModel(cfg), params)
    frames = torch.as_tensor(np.random.default_rng(8).integers(0, 256, size=(3, 48, 56, 3), dtype=np.uint8))
    stack = prepare_image(frames, cfg.image_size)
    torch.testing.assert_close(stack, torch.cat([prepare_image(f, cfg.image_size) for f in frames]), atol=0, rtol=0)
    with torch.no_grad():
        pyramid, pos = model.embed_frame(stack)
        for z in range(frames.shape[0]):
            one, one_pos = model.embed_frame(stack[z:z + 1])
            for level, (got, want) in enumerate(zip(pyramid, one)):
                assert got.shape[0] == frames.shape[0] and want.shape[0] == 1
                np.testing.assert_allclose(got[z:z + 1].numpy(), want.numpy(), atol=1e-5, rtol=0,
                                           err_msg=f"frame {z}, level {level}")
            for got, want in zip(pos, one_pos):
                torch.testing.assert_close(got, want, atol=0, rtol=0)
