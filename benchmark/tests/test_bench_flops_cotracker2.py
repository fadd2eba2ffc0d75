"""flops_cotracker2.py against a count made by hand for one window of the
released CoTracker2 (video-cotracker2-dinov2B) at the smooth stage's 548
points: 512 queries and the 6 x 6 support grid."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import flops_cotracker2

CT = json.loads((Path(__file__).resolve().parents[1] / "configs" / "video-cotracker2-dinov2B.json").read_text())[
    "cotracker2"]
N, S, V, D, C = 548, 8, 64, 384, 128


def test_the_encoder_of_one_frame_at_384_by_512():
    def conv(h, w, c_in, c_out, k):
        return 2 * h * w * c_in * k * k * c_out

    ops = conv(192, 256, 3, 64, 7)  # the stem
    ops += 4 * conv(192, 256, 64, 64, 3)  # stage 1: two blocks, no projection
    ops += conv(96, 128, 64, 96, 3) + conv(96, 128, 64, 96, 1) + 3 * conv(96, 128, 96, 96, 3)
    ops += conv(48, 64, 96, 128, 3) + conv(48, 64, 96, 128, 1) + 3 * conv(48, 64, 128, 128, 3)
    ops += conv(24, 32, 128, 128, 3) + conv(24, 32, 128, 128, 1) + 3 * conv(24, 32, 128, 128, 3)
    ops += conv(96, 128, 64 + 96 + 128 + 128, 256, 3) + conv(96, 128, 256, 128, 1)  # the fusion
    assert flops_cotracker2.encoder_frame(CT)[0] == ops


def test_one_iteration_of_one_window():
    # The correlation: per level a [S, N, h, w] volume of C-long dot
    # products, at 96x128, 48x64, 24x32 and 12x16.
    corr = 2 * S * N * C * (96 * 128 + 48 * 64 + 24 * 32 + 12 * 16)
    assert flops_cotracker2.correlation(CT, N)[0] == corr
    # The update former: the 456-wide input, then per block attention over
    # the S frames of each of the N + V tokens, virtual <- points, the
    # virtual tokens' self-attention and points <- virtual, each with
    # to_q, to_kv, to_out and a 4x MLP (20·D² a row of queries, 4·D² a row
    # of keys); the flow head and the feature update.
    t, sn, sv = (N + V) * S, S * N, S * V
    block = (20 * t * D * D + 4 * t * D * D + 4 * S * S * D * (N + V)
             + 20 * sv * D * D + 4 * sn * D * D + 4 * V * N * D * S
             + 20 * sv * D * D + 4 * sv * D * D + 4 * V * V * D * S
             + 20 * sn * D * D + 4 * sv * D * D + 4 * N * V * D * S)
    update = 2 * sn * 456 * D + 6 * block + 2 * sn * D * (C + 2) + 2 * sn * C * C
    assert flops_cotracker2.update_former(CT, N)[0] == pytest.approx(update, rel=1e-12)


def test_an_interval_of_12_frames_is_two_windows_of_six_iterations():
    enc = flops_cotracker2.encoder_frame(CT)[0]
    per_iter = flops_cotracker2.correlation(CT, N)[0] + flops_cotracker2.update_former(CT, N)[0]
    vis = 2 * S * N * C
    ops, nbytes = flops_cotracker2.interval(CT, N, 12)
    assert ops == pytest.approx(12 * enc + 2 * 6 * per_iter + 2 * vis, rel=1e-12)
    # The same from the program's counters of that interval.
    assert flops_cotracker2.work(CT, 12, 2, 12, 2 * N) == pytest.approx((ops, nbytes), rel=1e-12)
    # A window's level-0 volume alone is written once per iteration, in fp32.
    assert nbytes > 12 * 4 * S * N * 96 * 128
