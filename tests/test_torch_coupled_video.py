"""The coupled video step of the PyTorch port vs the JAX package, on the CPU.

- proposals_from_masks_video: crops within 1e-5 (the same fp32 gathers and
  weights), mask crops and bboxes identical, the empty-mask fallback box.
- StagedVideo: the bucket padding (repeats of the last frame) and prefix.
- Sam2VideoPredictor.propagate_batched on the tiny SAM2 video config with
  one seeded JAX-layout weight tree (random_sam2_video_params) in both
  packages: the same batch plan forward and reverse, the batch's frames as
  staged, low-res logits within 1e-4 (propagate_in_video with
  binarize=False: fp32 sums in another order over 7 frames of memory),
  bool masks equal except where the logit lies within 1e-4 of 0. Within the
  port, a batch's frames go through the image trunk in one call: batched
  propagation against frame-at-a-time within TRUNK_ATOL (the same fp32
  trunk at batch K and 1, sums blocked differently; 1.7e-6 seen), one
  trunk call and one `sam2.trunk` span per batch of the plan, at the
  batch's own size.
- StreamingInliers on the tiny refiner of test_torch_tracking_refiner, fed
  in order and shuffled: identical to the port's n_inliers_per_pose (same
  arithmetic), and against JAX's StreamingInliers inliers identical and the
  threshold within 1e-6, on that file's confidence inputs (six frames, one
  wrong pose). Named case: on frames rendered at exactly the scored poses
  every confidence lies near 1 and the threshold within 1e-6 of many of
  them, so a confidence 1e-5 away (the packages' fp32 ViT sums in another
  order) can cross it; there the port is held to its own n_inliers_per_pose
  only, which test_torch_tracking_refiner holds to JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.datasets import video as jvideo
from freepose_tpu.pipeline import proposals as jproposals
from freepose_tpu.pipeline import tracking_refiner as jtr
from freepose_tpu_torch.datasets.video import FRAME_BUCKET, StagedVideo, stage_frames, stage_frames_hbm
from freepose_tpu_torch.models.convert import random_sam2_video_params
from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor, batch_plan
from freepose_tpu_torch.pipeline import tracking_refiner as tr
from freepose_tpu_torch.pipeline.proposals import extract_proposals, proposals_from_masks_video
from freepose_tpu_torch.scripts.common import tiny_sam2_video_config
from freepose_tpu_torch.utils import timing
from tests.test_torch_tracking_refiner import K

CPU = torch.device("cpu")
LOGIT_ATOL = 1e-4
TRUNK_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _frames_and_masks():
    rng = np.random.default_rng(0)
    kf, h, w = 4, 96, 128
    frames = rng.integers(0, 255, size=(kf, h, w, 3), dtype=np.uint8)
    masks = np.zeros((kf, h, w), bool)
    masks[0, 10:40, 20:70] = True
    masks[1, 50:90, 5:60] = True
    masks[2, 30:35, 100:110] = True  # frame 3: empty, the centred half-frame box
    return frames, masks


def test_proposals_from_masks_video_matches_jax_and_the_host_path():
    frames, masks = _frames_and_masks()
    h, w = masks.shape[1:]
    crops, mcrops, bboxes = proposals_from_masks_video(torch.as_tensor(frames), torch.as_tensor(masks), 56, 0.2)
    jcrops, jmcrops, jbboxes = jproposals.proposals_from_masks_video(jnp.asarray(frames), jnp.asarray(masks),
                                                                     target_size=56, bbox_extend=0.2)
    assert crops.shape == (4, 3, 56, 56) and mcrops.shape == (4, 56, 56) and mcrops.dtype == torch.bool
    assert bboxes.dtype == torch.float32
    np.testing.assert_allclose(crops.numpy(), np.asarray(jcrops), atol=1e-5)
    np.testing.assert_array_equal(mcrops.numpy(), np.asarray(jmcrops))
    np.testing.assert_array_equal(bboxes.numpy(), np.asarray(jbboxes))
    np.testing.assert_array_equal(bboxes[3].numpy(), [w * 0.25, h * 0.25, w * 0.75, h * 0.75])
    for i in range(3):  # per frame, the host path on the same mask and box
        host = extract_proposals(torch.as_tensor(frames[i]), torch.as_tensor(masks[i:i + 1]), bboxes[i:i + 1],
                                 target_size=56, bbox_extend=0.2)
        np.testing.assert_allclose(crops[i].numpy(), host.proposals[0].numpy(), atol=1e-6)
        assert torch.equal(mcrops[i], host.masks[0])


def test_staged_video_pads_to_the_bucket_and_prefix_shares_the_buffer():
    frames, _ = _frames_and_masks()
    for bucket in (4, 8, FRAME_BUCKET):
        ours = stage_frames_hbm(frames[:3], bucket=bucket, device="cpu")
        ref = jvideo.stage_frames_hbm(frames[:3], bucket=bucket)
        assert isinstance(ours, StagedVideo) and len(ours) == ref.n == 3
        np.testing.assert_array_equal(ours.frames.numpy(), np.asarray(ref.frames))
        assert ours.frames.shape[0] == bucket and (ours.frames[3:] == ours.frames[2]).all()
    pre = ours.prefix(2)
    assert pre.n == 2 and pre.frames is ours.frames and ours.prefix(9).n == 3
    np.testing.assert_array_equal(stage_frames(frames, "cpu").numpy(), frames)
    with pytest.raises(ValueError, match="empty"):
        stage_frames_hbm(frames[:0], device="cpu")


@pytest.fixture(scope="module")
def predictors():
    from freepose_tpu.models.sam2.predictor import Sam2VideoPredictor as JaxPredictor
    from tests.test_sam2_video import OUR_CFG

    params = random_sam2_video_params(tiny_sam2_video_config(), seed=5)
    return (Sam2VideoPredictor(tiny_sam2_video_config(), params, device="cpu"),
            JaxPredictor(OUR_CFG, params, max_objects=1))


def _video():
    return (np.random.default_rng(1).random((7, 48, 56, 3)) * 255).astype(np.uint8)


def _prompted(pred, frames, start):
    st = pred.init_state(frames)
    return pred.add_new_points_or_box(st, start, obj_id=0, box=np.array([5.0, 5.0, 40.0, 40.0], np.float32))


@pytest.mark.parametrize("reverse,start", [(False, 0), (True, 4)])
def test_propagate_batched_matches_jax(predictors, reverse, start):
    ours, ref = predictors
    frames = _video()
    staged = stage_frames_hbm(frames, bucket=8, device="cpu")
    got = [(ts, lows.numpy(), highs.numpy(), fr.numpy())
           for ts, lows, highs, fr in ours.propagate_batched(_prompted(ours, staged, start), reverse=reverse,
                                                             chunk=3)]
    want = [(list(ts), np.asarray(lows), np.asarray(highs))
            for ts, lows, highs, _ in ref.propagate_batched(_prompted(ref, frames, start), reverse=reverse, chunk=3)]
    plan = [[0], [1, 2, 3], [4, 5, 6]] if not reverse else [[4], [3, 2, 1], [0]]
    assert [g[0] for g in got] == [w[0] for w in want] == plan
    # Logits through binarize=False (the port batched, JAX frame by frame).
    logits = {t: (low, high) for t, _, low, high in ours.propagate_in_video(_prompted(ours, frames, start),
                                                                           reverse=reverse, chunk=3)}
    jlogits = {t: (np.asarray(low), np.asarray(high)) for t, _, low, high in
               ref.propagate_in_video(_prompted(ref, frames, start), reverse=reverse, chunk=1)}
    for (ts, lows, highs, fr), (_, jlows, jhighs) in zip(got, want):
        assert lows.dtype == highs.dtype == bool and lows.shape == jlows.shape and highs.shape == jhighs.shape
        np.testing.assert_array_equal(fr, frames[ts])
        for z, t in enumerate(ts):
            (low, high), (jlow, jhigh) = logits[t], jlogits[t]
            np.testing.assert_allclose(low, jlow, atol=LOGIT_ATOL, err_msg=f"frame {t}")
            np.testing.assert_array_equal(lows[z], low > 0)
            np.testing.assert_array_equal(highs[z], high > 0)
            # Bool masks against JAX's: equal wherever the logit is clear of 0.
            assert not ((lows[z] != jlows[z]) & (np.abs(jlow) > LOGIT_ATOL)).any(), f"frame {t}"
            assert not ((highs[z] != jhighs[z]) & (np.abs(jhigh) > LOGIT_ATOL)).any(), f"frame {t}"


def test_batched_propagation_equals_frame_at_a_time(predictors):
    """Batches change when masks come back and the trunk's batch size, not
    the numbers beyond its rounding (batches of 4 and 3, the trunk at K = 4
    and 3); a StagedVideo and host frames give the same frames."""
    ours, _ = predictors
    frames = _video()
    one = [(t, low, high) for t, _, low, high in ours.propagate_in_video(_prompted(ours, frames, 0), chunk=1)]
    for chunk, src in ((4, stage_frames_hbm(frames, 8, "cpu")), (3, frames)):
        batched = [(t, low, high) for t, _, low, high in
                   ours.propagate_in_video(_prompted(ours, src, 0), chunk=chunk)]
        assert [t for t, _, _ in one] == [t for t, _, _ in batched] == list(range(7))
        for (_, a, b), (_, c, d) in zip(one, batched):
            np.testing.assert_allclose(c, a, atol=TRUNK_ATOL, rtol=0)
            np.testing.assert_allclose(d, b, atol=TRUNK_ATOL, rtol=0)
    with pytest.raises(ValueError, match="binarize"):
        next(ours.propagate_in_video(_prompted(ours, frames, 0), device_batches=True))


@pytest.mark.parametrize("reverse,start,chunk", [(False, 0, 3), (True, 4, 3), (False, 0, 1)])
def test_one_trunk_call_per_batch(predictors, monkeypatch, reverse, start, chunk):
    """The trunk runs once per batch of the plan, on the batch's frames and
    no more (a short batch is not padded; a batch of one runs alone)."""
    ours, _ = predictors
    sizes = []
    embed = type(ours.model).embed_frame

    def counting_embed(model, pixels):
        sizes.append(pixels.shape[0])
        return embed(model, pixels)

    monkeypatch.setattr(type(ours.model), "embed_frame", counting_embed)
    with timing.tracing():
        plan = [list(ts) for ts, *_ in ours.propagate_batched(_prompted(ours, _video(), start), reverse=reverse,
                                                               chunk=chunk)]
        trunks = [parent for name, parent, _, _ in timing.records if name == "sam2.trunk"]
    order = list(range(start, -1, -1)) if reverse else list(range(start, 7))
    assert plan == batch_plan(order, {start}, set(), chunk)
    assert sizes == [len(ts) for ts in plan]
    assert timing.counts["sam2.trunk_calls"] == len(trunks) == len(plan)
    assert set(trunks) == {"sam2.batch"} and timing.counts["sam2.frames"] == len(order)


def test_batch_plan_starts_runs_after_each_prompt_frame():
    assert batch_plan(list(range(10)), {0}, set(), 8) == [[0], list(range(1, 9)), [9]]
    assert batch_plan(list(range(8)), {0, 3}, set(), 8) == [[0], [1, 2], [3], [4, 5, 6, 7]]
    assert batch_plan(list(range(4)), {0}, set(), 1) == [[0], [1], [2], [3]]
    assert batch_plan([5, 4, 3, 2, 1, 0], {5, 9}, {9}, 4) == [[5], [4, 3, 2, 1], [0]]


# ------------------------------------------------------------ StreamingInliers

@pytest.fixture(scope="module")
def refiners():
    from tests.test_torch_tracking_refiner import pair

    return pair.__wrapped__()


def _feed(refiner, mesh, staged, poses, order, warmup=False):
    s = tr.StreamingInliers(refiner, mesh, staged, K, chunk=4)
    if warmup:
        s.warmup()
    for t in order:
        s.add(t, poses[t])
    return s.finalize()


def test_streaming_inliers_match_jax_in_order_and_shuffled(refiners):
    from scipy.spatial.transform import Rotation as Rot

    from tests.test_torch_tracking_refiner import _frames, _gt_poses

    ours, ref, mesh, jmesh = refiners
    poses = _gt_poses(6)
    poses[4, :3, :3] = Rot.from_rotvec([0, 1.5, 0]).as_matrix()  # one wrong pose
    frames = _frames(mesh, _gt_poses(6))
    si = jtr.StreamingInliers(ref, jmesh, jvideo.stage_frames_hbm(frames, bucket=8), jnp.asarray(K), chunk=4)
    for t in range(6):
        si.add(t, poses[t])
    jinl, jthr = si.finalize()
    staged = stage_frames_hbm(frames, bucket=8, device="cpu")
    for order in (range(6), [2, 0, 5, 1, 4, 3]):
        inl, thr = _feed(ours, mesh, staged, poses, order)
        np.testing.assert_array_equal(inl, jinl)
        assert abs(thr - jthr) <= 1e-6 and int(np.argmin(inl)) == 4


def test_streaming_inliers_equal_n_inliers_per_pose(refiners):
    from tests.test_torch_tracking_refiner import _frames, _gt_poses

    ours, _, mesh, _ = refiners
    poses = _gt_poses(5)  # not a multiple of the chunk: a tail chunk
    staged = stage_frames_hbm(_frames(mesh, poses), bucket=8, device="cpu")
    batch, batch_thr = ours.n_inliers_per_pose(mesh, staged.frames[:5], K, poses, chunk=4, channels_last=True)
    for order, warmup in ((range(5), True), ([2, 0, 4, 3, 1], False)):
        inl, thr = _feed(ours, mesh, staged, poses, order, warmup)
        np.testing.assert_array_equal(inl, batch)
        assert thr == batch_thr


def test_streaming_inliers_guards(refiners):
    from tests.test_torch_tracking_refiner import _frames, _gt_poses

    ours, _, mesh, _ = refiners
    poses = _gt_poses(3)
    frames = _frames(mesh, poses)
    with pytest.raises(TypeError):
        tr.StreamingInliers(ours, mesh, frames, K)
    staged = stage_frames_hbm(frames, bucket=4, device="cpu")
    with pytest.raises(ValueError, match="multiple of chunk"):
        tr.StreamingInliers(ours, mesh, staged, K, chunk=3)
    s = tr.StreamingInliers(ours, mesh, staged, K, chunk=4)
    s.add(0, poses[0])
    with pytest.raises(ValueError, match="missing"):
        s.finalize()
