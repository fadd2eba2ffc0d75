"""Object-sharded SAM2 video propagation in both packages, on the CPU.

The JAX predictor shards its per-object axis over "data" on conftest's 8
virtual CPU devices (make_mesh(data=8, model=1)); the port's over
make_mesh(data=8, model=1) on the one `cpu` device repeated, so 3 objects
pad to 8 with no-prompt dummies and each shard steps one object. JAX's
tiny video config (tests/test_sam2_video.py's OUR_CFG, the port's
tiny_sam2_video_config) and one seeded parameter tree in the JAX layout
(sam2_video_from_jax) in both.

Tolerances: within the port, the sharded run's binarised masks equal the
unsharded run's and its low-res logits are within 1e-4; against JAX's
sharded run the low-res logits are within 1e-3 and the binarised high-res
masks differ on at most MASK_PX pixels, the tolerances of the unsharded
parity test (test_torch_video_slice.py): fp32 over 4 frames of memory
feedback.
"""
import jax
import numpy as np
import pytest
import torch

from freepose_tpu.models.sam2.predictor import Sam2VideoPredictor as JaxPredictor
from freepose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from freepose_tpu_torch.models.convert import random_sam2_video_params
from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
from freepose_tpu_torch.parallel.mesh import make_mesh
from freepose_tpu_torch.scripts.common import tiny_sam2_video_config
from freepose_tpu_torch.utils import timing
from tests.test_sam2_video import OUR_CFG

MASK_PX = 4

PROMPTS3 = [
    (7, 0, dict(box=np.array([5, 5, 30, 30]))),
    (9, 0, dict(points=np.array([[50.0, 20.0]]), labels=np.array([1]))),
    (11, 0, dict(box=np.array([20, 10, 60, 40]))),
]
PROMPTS_TWO_FRAMES = [
    (1, 0, dict(box=np.array([5, 5, 30, 30]))),
    (2, 2, dict(points=np.array([[40.0, 24.0]]), labels=np.array([1]))),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return random_sam2_video_params(tiny_sam2_video_config(), seed=5)


def _run(pred, frames, prompts, **kw):
    state = pred.init_state(frames)
    for obj_id, frame_idx, kwargs in prompts:
        state = pred.add_new_points_or_box(state, frame_idx, obj_id=obj_id, **kwargs)
    return [(t, ids, np.asarray(low, np.float32), np.asarray(high)) for t, ids, low, high in
            pred.propagate_in_video(state, **kw)]


@pytest.mark.parametrize("case", ["three_objects", "two_prompt_frames"])
def test_sharded_propagation_matches_jax_and_unsharded(params, case):
    """Three objects on frame 0; or two objects prompted on frames 0 and 2
    (two groups, each padded to the 8 shards) with the non-overlap
    constraint, frame by frame (chunk 1) and in the batch plan (chunk 8)."""
    prompts = PROMPTS3 if case == "three_objects" else PROMPTS_TWO_FRAMES
    kw = {} if case == "three_objects" else dict(non_overlap_masks=True)
    frames = (np.random.default_rng(5).random((4, 48, 80, 3)) * 255).astype(np.uint8)
    cfg = tiny_sam2_video_config()
    mesh = make_mesh(data=8, model=1, devices=["cpu"] * 8)
    shard = Sam2VideoPredictor(cfg, params, max_objects=4, device_mesh=mesh)
    assert shard.device == torch.device("cpu") and list(shard._models) == [torch.device("cpu")]
    base = Sam2VideoPredictor(cfg, params, max_objects=4, device="cpu")
    ref = _run(JaxPredictor(OUR_CFG, jax.tree.map(np.asarray, params), max_objects=4,
                            device_mesh=jax_make_mesh(data=8, model=1)), frames, prompts, binarize=False, **kw)
    for chunk in (1, 8):
        got = _run(shard, frames, prompts, chunk=chunk, **kw)
        one = _run(base, frames, prompts, chunk=chunk, **kw)
        assert len(got) == len(one) == len(ref) == 4
        for (t, ids, low, high), (t1, ids1, low1, high1), (tr, idsr, lowr, highr) in zip(got, one, ref):
            assert t == t1 == tr and ids == ids1 == idsr
            np.testing.assert_allclose(low, low1, atol=1e-4, err_msg=f"frame {t}")
            np.testing.assert_array_equal(high > 0, high1 > 0, err_msg=f"frame {t}")
            np.testing.assert_allclose(low, lowr, atol=1e-3, err_msg=f"frame {t}")
            assert int(((high > 0) != (highr > 0)).sum()) <= MASK_PX, f"frame {t}"
    binarized = _run(shard, frames, prompts, binarize=True, **kw)
    for (t, _, low, high), (_, _, low1, high1) in zip(binarized, one):
        np.testing.assert_array_equal(low, low1 > 0, err_msg=f"frame {t}")
        np.testing.assert_array_equal(high, high1 > 0, err_msg=f"frame {t}")


def test_sharded_trunk_runs_once_per_batch_on_a_repeated_device(params):
    """On a mesh of one device repeated, the trunk embeds each batch of the
    plan once, as the unsharded predictor does, not once per shard."""
    frames = (np.random.default_rng(5).random((7, 48, 80, 3)) * 255).astype(np.uint8)
    cfg = tiny_sam2_video_config()
    calls = []
    for mesh in (make_mesh(data=8, model=1, devices=["cpu"] * 8), None):
        pred = Sam2VideoPredictor(cfg, params, max_objects=4, device="cpu", device_mesh=mesh)
        with timing.tracing():
            plan = [t for t, *_ in _run(pred, frames, PROMPTS3, binarize=True, chunk=3)]
            calls.append((timing.counts["sam2.trunk_calls"], timing.counts["sam2.frames"],
                          sum(r[0] == "sam2.trunk" for r in timing.records)))
    assert plan == list(range(7))
    assert calls[0] == calls[1] == (3, 7, 3)  # batches [0], [1, 2, 3], [4, 5, 6]


def test_sharded_mask_prompts_pad_with_empty_masks(params):
    """A mask-prompted group of 3 objects over 2 shards: one empty-mask
    dummy, dropped before assembly."""
    frames = (np.random.default_rng(6).random((3, 48, 80, 3)) * 255).astype(np.uint8)
    cfg = tiny_sam2_video_config()
    runs = []
    for mesh in (make_mesh(data=2, model=1, devices=["cpu"] * 2), None):
        pred = Sam2VideoPredictor(cfg, params, device="cpu", device_mesh=mesh)
        state = pred.init_state(frames)
        for i, (y, x) in enumerate(((5, 5), (20, 30), (10, 50))):
            m = np.zeros((48, 80), bool)
            m[y:y + 15, x:x + 20] = True
            state = pred.add_new_mask(state, 0, obj_id=i, mask=m)
        runs.append([(t, ids, np.asarray(low), np.asarray(high)) for t, ids, low, high in
                     pred.propagate_in_video(state, binarize=True, chunk=1)])
    for (t, ids, low, high), (t1, ids1, low1, high1) in zip(*runs):
        assert t == t1 and ids == ids1 == [0, 1, 2] and low.shape[0] == 3
        np.testing.assert_array_equal(high, high1)
        np.testing.assert_array_equal(low, low1)


def test_sharded_predictor_device_checks(params):
    with pytest.raises(ValueError, match="not the mesh's first device"):
        Sam2VideoPredictor(tiny_sam2_video_config(), params, device="cpu",
                           device_mesh=make_mesh(devices=["meta"]))
