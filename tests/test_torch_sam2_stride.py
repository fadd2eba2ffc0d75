"""SAM2's memory stride (memory_temporal_stride r > 1) in the PyTorch port
vs the JAX package, on the CPU, on the tiny SAM2 video config with one
seeded JAX-layout weight tree in both (random_sam2_video_params).

- The memory frames held after every step equal JAX's at r = 2 and 3,
  forward and reverse, over 14 frames, and contain the reference's
  selection for the next frame (slot 0 the conditioning frame; the last
  frame; the frames anchor - k·r, anchor = ((v-2)//r)·r in virtual time
  v = sign·frame).
- Every step's outputs at r = 2 against JAX's: mask logits within rtol
  1e-3 / atol 1e-4 (the JAX stride test's own tolerance), IoU and object
  scores within 1e-4 / 1e-5.
- r = 2 propagation through the predictor: finite masks on every frame.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.models.sam2.video import init_object_state as jax_init_object_state
from freepose_tpu_torch.models.convert import random_sam2_video_params
from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
from freepose_tpu_torch.models.sam2.video import init_object_state
from freepose_tpu_torch.scripts.common import tiny_sam2_video_config

N_FRAMES = 14


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _with_stride(cfg, r):
    return dataclasses.replace(cfg, mem=dataclasses.replace(cfg.mem, memory_temporal_stride=r))


@pytest.fixture(scope="module", params=[2, 3])
def pair(request):
    from freepose_tpu.models.sam2.predictor import Sam2VideoPredictor as JaxPredictor
    from tests.test_sam2_video import OUR_CFG

    r = request.param
    cfg = _with_stride(tiny_sam2_video_config(), r)
    params = random_sam2_video_params(cfg, seed=7)
    return r, Sam2VideoPredictor(cfg, params, device="cpu"), JaxPredictor(_with_stride(OUR_CFG, r), params)


def _frames():
    return (np.random.default_rng(0).random((N_FRAMES, 48, 48, 3)) * 255).astype(np.uint8)


def _reference_selection(t, cond, num_maskmem, r, sign):
    """The reference's memory frames at frame t besides the conditioning
    one: the last frame and the r-grid frames, in virtual time."""
    v = sign * t
    anchor = ((v - 2) // r) * r
    frames = {v - 1} | {anchor - k * r for k in range(num_maskmem - 2)}
    return {sign * f for f in frames if f > sign * cond}


def _run(ours, ref, reverse):
    """Step both packages over the video from its prompt frame (0, or the
    last frame when reverse) -> per step (frame, port held set, JAX held
    set, port outputs, JAX outputs)."""
    frames = _frames()
    order = list(range(N_FRAMES - 1, -1, -1)) if reverse else list(range(N_FRAMES))
    cap = ours.config.max_point_prompts
    pts = np.zeros((cap, 2), np.float32)
    pts[:2] = [[4.0, 4.0], [30.0, 30.0]]
    lbl = np.full((cap,), -10, np.int32)
    lbl[:2] = [2, 3]
    st = init_object_state(ours.config, 1)
    jst = jax.tree.map(lambda x: jnp.stack([x]), jax_init_object_state(ref.config))
    jstate = ref.init_state(frames)
    pstate = ours.init_state(frames)
    out = []
    for i, t in enumerate(order):
        pyr, pos = ours._frame_pyramid(pstate, t)
        jpyr, jpos = ref._frame_pyramid(jstate, t)
        args = (jpyr, jpyr[2], jpos[2], jnp.int32(t), jnp.int32(N_FRAMES))
        with torch.inference_mode():
            if i == 0:
                st, o = ours.model.track_step(st, pyr, pyr[2], pos[2], t, N_FRAMES,
                                              points=torch.as_tensor(pts)[None, None],
                                              labels=torch.as_tensor(lbl).long()[None, None], is_init=True)
                jst, jo = ref._init_step(ref.params, jst, *args, jnp.asarray(pts)[None, None, None],
                                         jnp.asarray(lbl)[None, None, None])
            else:
                st, o = ours.model.track_step(st, pyr, pyr[2], pos[2], t, N_FRAMES, reverse=reverse)
                step = ref._track_step_rev if reverse else ref._track_step
                jst, jo = step(ref.params, jst, *args)
        held = {int(f) for f, v in zip(st.maskmem_frame[0].tolist(), st.maskmem_valid[0].tolist()) if v}
        jheld = {int(f) for f, v in zip(np.asarray(jst.maskmem_frame[0]), np.asarray(jst.maskmem_valid[0])) if v}
        out.append((t, held, jheld, {k: v.float().numpy() for k, v in o.items()},
                    {k: np.asarray(v[0]) for k, v in jo.items()}))
    return out


@pytest.mark.parametrize("reverse", [False, True])
def test_held_memory_frames_match_jax_and_the_reference(pair, reverse):
    r, ours, ref = pair
    steps = _run(ours, ref, reverse)
    sign = -1 if reverse else 1
    cond = steps[0][0]
    nm = ours.config.mem.num_maskmem
    for t, held, jheld, _, _ in steps:
        assert held == jheld, f"r={r} reverse={reverse} frame {t}: port {sorted(held)}, JAX {sorted(jheld)}"
        nxt = t + sign
        if 0 <= nxt < N_FRAMES and t != cond:
            need = _reference_selection(nxt, cond, nm, r, sign)
            assert need <= held and cond in held, f"r={r} frame {t}: need {sorted(need)}, held {sorted(held)}"
    if r == 2:
        for t, _, _, o, jo in steps:
            np.testing.assert_allclose(o["pred_masks"], jo["pred_masks"], rtol=1e-3, atol=1e-4,
                                       err_msg=f"mask logits, frame {t}")
            np.testing.assert_allclose(o["iou_scores"], jo["iou_scores"], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(o["object_score_logits"], jo["object_score_logits"], rtol=1e-4, atol=1e-5)


def test_stride_propagation_is_finite():
    cfg = _with_stride(tiny_sam2_video_config(), 2)
    pred = Sam2VideoPredictor(cfg, random_sam2_video_params(cfg, seed=1), device="cpu")
    frames = (np.random.default_rng(1).random((10, 48, 48, 3)) * 255).astype(np.uint8)
    state = pred.add_new_points_or_box(pred.init_state(frames), 0, obj_id=0, box=np.array([4, 4, 30, 30]))
    outs = [(t, low, high) for t, _, low, high in pred.propagate_in_video(state)]
    assert [t for t, _, _ in outs] == list(range(10))
    assert all(np.isfinite(low).all() and np.isfinite(high).all() for _, low, high in outs)
    assert init_object_state(cfg).ring_pos == 2 and init_object_state(tiny_sam2_video_config()).ring_pos == 1
