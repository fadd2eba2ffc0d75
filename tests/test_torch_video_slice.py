"""The video proposal slice through both packages' CLIs, on the CPU.

extract_proposals_ground_video --detector boxes, JAX CLI and port CLI
in-process, on one seeded 4-frame 64² video with two boxed objects, one
.npz of JAX-layout SAM2 weights (the tiny video config, seeded by
models/convert.py:random_sam2_video_params) and one .npz of the JAX VIT_TEST
DINOv2 weights, FREEPOSE_TINY_MODELS=1. Both run fp32 with plain attention.
The proposal JSONs agree: the same (frame, track) entries with the same mesh
per track, RLE masks that differ in at most MASK_PX pixels per frame
(logits near 0 may flip sign after fp32 sums in another order; the
tracker's masks are otherwise identical), boxes within one pixel, and
soft-vote scores within 1e-4.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from freepose_tpu.io.rle import decode_rle
from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
from freepose_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from freepose_tpu_torch.models.convert import random_sam2_video_params
from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
from freepose_tpu_torch.scripts.common import tiny_sam2_video_config

N_FRAMES, SIZE, MASK_PX = 4, 64, 4
MESHES = ["mesh_a", "mesh_b", "mesh_c", "mesh_d", "mesh_e"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from scripts.common import save_params

    ws = tmp_path_factory.mktemp("torch_video")
    rng = np.random.default_rng(0)
    (ws / "frames").mkdir()
    for t in range(N_FRAMES):  # two bright squares drifting over a noisy background
        img = (rng.random((SIZE, SIZE, 3)) * 80).astype(np.uint8)
        img[10 + t:34 + t, 6 + t:30 + t] = [220, 60, 40]
        img[30 - t:56 - t, 36:60] = [40, 90, 230]
        Image.fromarray(img).save(ws / "frames" / f"{t:05d}.png")
    np.save(ws / "boxes.npy", np.array([[6, 10, 30, 34], [36, 30, 60, 56]], np.float32))
    bank = rng.standard_normal((len(MESHES), JAX_VIT_TEST.hidden_size)).astype(np.float32)
    np.save(ws / "bank.npy", bank)
    (ws / "banklist.txt").write_text("\n".join(MESHES) + "\n")
    save_params(random_sam2_video_params(tiny_sam2_video_config(), seed=0), ws / "sam2.npz")
    dino = JaxDinoV2(JAX_VIT_TEST).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28)))["params"]
    save_params(jax.tree_util.tree_map(np.asarray, dino), ws / "dinov2.npz")
    return ws


def _argv(ws, out: str) -> list[str]:
    return ["--video-dir", str(ws / "frames"), "--bank", str(ws / "bank.npy"),
            "--filelist", str(ws / "banklist.txt"), "--out", str(ws / out), "--detector", "boxes",
            "--boxes", str(ws / "boxes.npy"), "--sam2-weights", str(ws / "sam2.npz"),
            "--weights", str(ws / "dinov2.npz"), "--min-mask-px", "30"]


def test_video_proposals_cli_matches_jax(workspace, monkeypatch):
    import importlib

    from freepose_tpu_torch.scripts import extract_proposals_ground_video

    ws = workspace
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.setattr(sys, "argv", ["extract_proposals_ground_video", *_argv(ws, "jax.json")])
    importlib.import_module("scripts.extract_proposals_ground_video").main()
    extract_proposals_ground_video.main(_argv(ws, "torch.json") + ["--device", "cpu"])

    ref = json.loads((ws / "jax.json").read_text())
    ours = json.loads((ws / "torch.json").read_text())
    key = lambda p: (p["track_id"], p["image_id"])  # noqa: E731
    assert sorted(map(key, ours)) == sorted(map(key, ref))
    assert {p["track_id"] for p in ref} == {0, 1}, "both objects retrieved on some frame"
    assert len(ref) >= N_FRAMES
    ref_by = {key(p): p for p in ref}
    for p in ours:
        r = ref_by[key(p)]
        assert p["mesh"] == r["mesh"] and p["mesh"] in MESHES
        np.testing.assert_allclose(p["score"], r["score"], atol=1e-4)
        np.testing.assert_allclose(p["bbox"], r["bbox"], atol=1)
        differ = int((decode_rle(p["segmentation"]) != decode_rle(r["segmentation"])).sum())
        assert differ <= MASK_PX, f"{key(p)}: {differ} mask pixels differ"


def test_video_proposals_cli_drops_small_masks_as_jax(workspace, monkeypatch):
    """A tracked mask below --min-mask-px gives no proposal on its frame, the
    last frame included, in both CLIs: the tracked masks here hold 3,076 to
    4,080 px on track 0 and 740 to 3,362 px on track 1, so a floor of 3,264
    px drops (track, frame) (0, 1), (0, 3) and (1, 0), more than MASK_PX from
    any mask's size."""
    import importlib

    from freepose_tpu_torch.scripts import extract_proposals_ground_video

    ws = workspace
    argv = [a if a != "30" else "3264" for a in _argv(ws, "jax_floor.json")]
    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.setattr(sys, "argv", ["extract_proposals_ground_video", *argv])
    importlib.import_module("scripts.extract_proposals_ground_video").main()
    extract_proposals_ground_video.main([a.replace("jax_floor", "torch_floor") for a in argv] + ["--device", "cpu"])

    key = lambda p: (p["track_id"], p["image_id"])  # noqa: E731
    ref = sorted(map(key, json.loads((ws / "jax_floor.json").read_text())))
    ours = sorted(map(key, json.loads((ws / "torch_floor.json").read_text())))
    assert ours == ref
    assert ref == [(0, 0), (0, 2), (1, 1), (1, 2), (1, 3)]


def test_video_cli_refuses_what_is_not_ported(workspace, monkeypatch):
    """--shard-objects is ported: under --device cpu it builds a one-device
    mesh (the flag adds no shard count) and writes the proposals of the
    unsharded run."""
    from freepose_tpu_torch.scripts import extract_proposals_ground_video

    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")
    monkeypatch.delenv("FREEPOSE_COORDINATOR", raising=False)
    argv = _argv(workspace, "plain.json") + ["--device", "cpu"]
    extract_proposals_ground_video.main(argv)
    extract_proposals_ground_video.main([a.replace("plain.json", "shard.json") for a in argv] + ["--shard-objects"])
    plain, shard = (json.loads((workspace / name).read_text()) for name in ("plain.json", "shard.json"))
    assert len(shard) == len(plain) > 0
    assert shard == plain


@pytest.mark.parametrize("reverse", [False, True])
def test_video_predictor_matches_jax_with_mixed_prompts(reverse, monkeypatch):
    """Sam2VideoPredictor in both packages on one tiny config and weights:
    object 0 boxed on frame 1, object 1 prompted by a mask on frame 2, so
    two prompt groups of two kinds; non-overlapping masks; forward from
    frame 1, or reverse from frame 1 (object 1 conditioned at its own frame
    first). Low-res logits agree to 1e-3 (fp32, 4 frames of memory
    feedback), binarised high-res masks on all but MASK_PX pixels."""
    from freepose_tpu.models.sam2.predictor import Sam2VideoPredictor as JaxPredictor
    from scripts.common import production_sam2_video_config as jax_video_config

    monkeypatch.setenv("FREEPOSE_TINY_MODELS", "1")  # the JAX package's tiny video config
    cfg = tiny_sam2_video_config()
    params = random_sam2_video_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    frames = (rng.random((N_FRAMES, 48, 80, 3)) * 255).astype(np.uint8)
    mask = np.zeros((48, 80), bool)
    mask[20:40, 40:70] = True
    runs = []
    for pred in (JaxPredictor(jax_video_config(), params),
                 Sam2VideoPredictor(cfg, params, device="cpu")):
        state = pred.init_state(frames)
        state = pred.add_new_points_or_box(state, 1, obj_id=7, box=np.array([5.0, 4.0, 38.0, 30.0]))
        state = pred.add_new_mask(state, 2, obj_id=9, mask=mask)
        runs.append([(t, ids, np.asarray(low, np.float32), np.asarray(high) > 0) for t, ids, low, high in
                     pred.propagate_in_video(state, non_overlap_masks=True, reverse=reverse, chunk=1)])
    ref, ours = runs
    assert [(t, ids) for t, ids, _, _ in ours] == [(t, ids) for t, ids, _, _ in ref]
    assert [t for t, _, _, _ in ours] == ([1, 0] if reverse else [1, 2, 3])
    for (t, _, low, high), (_, _, jlow, jhigh) in zip(ours, ref):
        np.testing.assert_allclose(low, jlow, atol=1e-3, err_msg=f"frame {t}")
        assert int((high != jhigh).sum()) <= MASK_PX, f"frame {t}"

