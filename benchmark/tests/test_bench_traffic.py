"""The inputs come from the seed alone: the same seed gives the same mesh,
weights, videos and sample; every seed gives inputs of the same sizes."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import synth, weights
from benchmark.reference import models, video_check
from benchmark.tests.conftest import tiny_config

SEED = 3_000_000_019  # more than 31 bits: seeds run past a signed 32-bit integer


def videos(seed):
    mesh = synth.bumpy_torus(seed, 16, 8)
    return mesh, synth.make_videos(seed, mesh, 2, 6, (72, 128), 32, 2.0, "cpu")


def test_videos_and_mesh_repeat_for_a_seed_and_keep_their_sizes_across_seeds():
    mesh_a, va = videos(SEED)
    mesh_b, vb = videos(SEED)
    mesh_c, vc = videos(SEED + 1)
    for a, b in zip(mesh_a, mesh_b):
        assert np.array_equal(a, b)
    assert not np.array_equal(mesh_a[0], mesh_c[0])
    for x, y, z in zip(va, vb, vc):
        assert np.array_equal(x["frames"], y["frames"]) and torch.equal(x["mask"], y["mask"])
        assert np.array_equal(x["box0"], y["box0"])
        assert x["frames"].shape == z["frames"].shape and not np.array_equal(x["frames"], z["frames"])
        assert bool(x["mask"][0].any()) and bool(z["mask"][0].any())


def test_weights_repeat_for_a_seed_and_follow_the_init_rules():
    spec = models.spec_sam2(tiny_config())
    a = weights.make_weights(spec, SEED, "cpu", torch.bfloat16)
    b = weights.make_weights(spec, SEED, "cpu", torch.bfloat16)
    c = weights.make_weights(spec, SEED + 1, "cpu", torch.bfloat16)
    assert a.keys() == b.keys() == {n for n, _ in spec.named_parameters()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert all(torch.equal(v, v.bfloat16().float()) for v in a.values())
    bias = a["image.decoder.obj_head.proj_out.bias"]
    assert float(bias.mean()) > 9.0


def test_the_checked_frames_repeat_for_a_seed():
    s = video_check.sample_frames(SEED, 128, 6)
    assert s == video_check.sample_frames(SEED, 128, 6)
    assert len(s) == 6 and s[0] == 0 and s[-1] == 127
