"""flops.py and roofline.py against counts made by hand."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import flops, roofline

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "video-hieraL-dinov2L.json").read_text())


def test_one_dinov2_l_layer_at_420():
    n, d = 30 * 30 + 1 + 4, 1024  # 905 tokens
    layer = flops.vit_layer(CFG["dinov2_l"], n)
    # qkv 2·n·d·3d, proj 2·n·d·d, MLP 2·n·d·4d twice: 24·n·d².
    assert layer["matmul"] == 24 * n * d * d
    assert layer["attention"] == 4 * n * n * d
    assert layer["attention_bytes"] == 4 * n * d * 2


def test_hiera_l_stage_3():
    # Stage 3 at 1024²: 36 blocks on 64x64 tokens at 576 channels; block 8
    # pools its queries from stage 2's 128x128 tokens at 288 channels in
    # windows of 4 (2x2 queries each); blocks 23, 33 and 43 attend globally,
    # the rest in 16x16 windows.
    stage = flops.hiera(CFG["sam2"])["stages"][2]
    n_in, n, d_in, d = 128 * 128, 64 * 64, 288, 576
    first = 2 * n_in * d_in * 3 * d + 2 * n * d * d + 16 * n * d * d + 2 * n_in * d_in * d + 4 * n * 16 * d
    windowed = 24 * n * d * d + 4 * n * 256 * d
    global_ = 24 * n * d * d + 4 * n * n * d
    assert stage == pytest.approx(first + 32 * windowed + 3 * global_, rel=1e-12)
    assert flops.hiera(CFG["sam2"])["global_attention"] == 3 * 4 * n * n * d


def test_memory_keys_grow_to_seven_frames_and_sixteen_pointers():
    assert flops.memory_keys(CFG["sam2"], 0) == (0, 0)
    assert flops.memory_keys(CFG["sam2"], 1) == (4096, 4)
    assert flops.memory_keys(CFG["sam2"], 7) == (7 * 4096, 7 * 4)
    assert flops.memory_keys(CFG["sam2"], 100) == (7 * 4096, 16 * 4)


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.share(1.0, 4.0) == pytest.approx(25.0)
    assert roofline.share(1.0, 0.0) is None
    kernels = [("void flash::sm90_attention_kernel<64, 1, false>(Maps)", 2.0),
               ("void flash::sm90_attention_kernel<256, 2, true>(Maps)", 3.0),
               ("void flash::split_combine_kernel<__nv_bfloat16>(...)", 0.5), ("ampere_gemm", 9.0)]
    assert roofline.group_device_s(kernels, "k2_d64") == 2.0
    assert roofline.group_device_s(kernels, "sam2_attention") == 3.5
