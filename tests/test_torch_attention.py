"""Attention K2, K3, K4 and K5 in the PyTorch port vs the JAX package.

On the CPU the port's wrappers run their plain versions (`dense_attention`,
`dense_attention_masked`); they are held against the JAX Pallas kernels in
interpret mode and against the dense XLA path on the same numpy inputs. So
is the plain version of the sm90 kernel's key split (`attention_partials`
per key range, merged by `combine_partials`), unmasked and over equal shares
of a masked call's key-tile list (`key_tile_list`, itself held against a
numpy reference), and the dispatch rule and split rule of `_launch` are
checked as the pure functions they are.

Tolerances: fp32 atol 1e-5 (same arithmetic, summation order differs);
bf16 atol 2e-2 (outputs of O(1) size rounded to bf16's 8-bit mantissa, and
the kernel's online softmax rescales in another order than the one-pass
softmax). The kernel itself is held against the plain version on the card
in tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.ops.attention import dense_attention_masked as jax_dense
from freepose_tpu.ops.attention import flash_attention as jax_flash
from freepose_tpu.ops.attention import flash_attention_stream as jax_stream
from freepose_tpu_torch.ops.attention import (MIN_SPLIT_TILES, WAVE_COST, attention_combine, attention_kernel,
                                              attention_partials, combine_partials, dense_attention,
                                              dense_attention_bias, dense_attention_masked, flash_attention,
                                              flash_attention_auto, flash_attention_bias, flash_attention_bias_auto,
                                              flash_attention_stream, flash_attention_sm90, key_tile_list,
                                              key_tiles, sm90_config)
from freepose_tpu_torch.ops.attention import K5_KEY_TILE, bias_combine, k5_config
from freepose_tpu_torch.utils import timing

SCALE = 64**-0.5
# Keys per tile of the sm90 kernel (`Sm90::BK`; on the card `sm90_key_tile` reads
# them from the library), which the split rule's expectations below assume.
KEY_TILE = {64: 128, 72: 128, 256: 64}


def _qkv(n, b=2, h=3, d=64, seed=0, nk=None):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, length, d)).astype(np.float32) for length in (n, nk or n, nk or n)]


@pytest.mark.parametrize("n", [16, 37, 130])
def test_plain_matches_jax_fp32(n):
    q, k, v = _qkv(n)
    ours = flash_attention(*map(torch.as_tensor, (q, k, v)), SCALE).numpy()
    ref_kernel = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), SCALE, interpret=True))
    ref_dense = np.asarray(jax_dense(*map(jnp.asarray, (q, k, v)), SCALE))
    np.testing.assert_allclose(ours, ref_kernel, atol=1e-5)
    np.testing.assert_allclose(ours, ref_dense, atol=1e-5)


@pytest.mark.parametrize("n", [16, 37])
def test_plain_matches_jax_bf16(n):
    q, k, v = _qkv(n, seed=1)
    ours = dense_attention(*(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)), SCALE)
    assert ours.dtype == torch.bfloat16
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref_kernel = np.asarray(jax_flash(*jb, SCALE, interpret=True).astype(jnp.float32))
    ref_dense = np.asarray(jax_dense(*jb, SCALE).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref_kernel, atol=2e-2)
    np.testing.assert_allclose(ours.float().numpy(), ref_dense, atol=2e-2)


def test_cpu_tensor_runs_plain_version_without_launch():
    q, k, v = map(torch.as_tensor, _qkv(20, seed=2))
    with timing.tracing():
        before = tuple(timing.counts.get(f"launch.{kernel}", 0) for kernel in ("k2", "k3", "k4"))
        out = flash_attention(q, k, v, SCALE)
        torch.testing.assert_close(out, dense_attention(q, k, v, SCALE), rtol=0, atol=0)
        flash_attention(q, k, v, SCALE, single_budget=0)
        flash_attention_auto(q, k, v, SCALE, kv_mask=torch.ones((2, 20), dtype=torch.bool))
        assert tuple(timing.counts.get(f"launch.{kernel}", 0) for kernel in ("k2", "k3", "k4")) == before


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q, SCALE)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_partials_combine_to_jax_streaming(splits, dtype, tol):
    """The plain version of the sm90 kernel's key split: (m, l, acc) of each
    of 1-4 uneven key ranges (`attention_partials`), merged by
    `combine_partials`, give the JAX streaming kernel's output
    (`single_budget=0`, interpret mode) on the same numpy inputs, and the
    combine wrapper on CPU tensors is that plain version."""
    q, k, v = _qkv(40, b=1, h=2, d=64, seed=12, nk=300)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(tdtype) for x in (jq, jk, jv))
    bounds = [0, *sorted(np.random.default_rng(splits).choice(np.arange(1, 300), splits - 1, replace=False)), 300]
    parts = [attention_partials(tq, tk[:, :, a:b], tv[:, :, a:b], SCALE) for a, b in zip(bounds, bounds[1:])]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    ours = combine_partials(m, l, acc, tdtype)
    ref = np.asarray(jax_flash(jq, jk, jv, SCALE, block_k=128, single_budget=0, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol)
    with timing.tracing():
        before = timing.counts.get("launch.attention_combine", 0)
        torch.testing.assert_close(attention_combine(m, l, acc, tdtype), ours, rtol=0, atol=0)
        assert timing.counts.get("launch.attention_combine", 0) == before


@pytest.mark.parametrize("dtype,d,masked,kernel", [
    (torch.bfloat16, 64, False, "sm90"), (torch.bfloat16, 256, False, "sm90"),
    (torch.bfloat16, 72, False, "sm90"), (torch.bfloat16, 64, True, "sm90"),
    (torch.bfloat16, 72, True, "sm90"), (torch.bfloat16, 256, True, "sm90"),
    (torch.float32, 64, False, "f32"),
])
def test_dispatch_rule(dtype, d, masked, kernel):
    """Every bf16 call, K2 and K3 at d 64, 72 and 256 and every masked call
    (K4), goes to the wgmma + TMA kernel; fp32 to its own."""
    assert attention_kernel(dtype, d, masked) == kernel


@pytest.mark.parametrize("bh,n,nk,d,masked,config", [
    (128 * 16, 905, 905, 64, False, (3, 1)),  # the template pack's ViT batch: 78 waves of 192-row blocks vs 117
    (8 * 16, 905, 905, 64, False, (3, 1)),  # 8 crops: 5 waves vs 8
    (4 * 16, 905, 905, 64, False, (1, 1)),  # a frame of 4 proposals: 3 waves of 192-row blocks vs 4 of 64-row
    (2 * 16, 905, 905, 64, False, (1, 1)),  # 2 retrieval crops: 480 blocks of 64 rows, 2 per SM
    (1 * 16, 905, 905, 64, False, (1, 1)),  # 1 crop: 240 blocks; 8 key tiles leave nothing to split
    (2, 4096, 4096, 256, False, (2, 2)),  # memory self-attention: 64 blocks of 128 rows -> 2 splits
    (1, 4096, 6144, 256, False, (2, 4)),  # K3's shape: 32 blocks -> 4 splits of 24 key tiles
    (8, 4096, 4096, 72, False, (2, 1)),  # a Hiera-L global block: 2 waves of 64-, 128- or 192-row blocks
    (2, 4096, 28736, 256, True, (2, 4)),  # K4: 64 blocks of 128 rows, 449 key tiles; twice the 2 splits
])
def test_sm90_config_at_the_main_path_shapes(bh, n, nk, d, masked, config):
    assert sm90_config(bh, n, nk, d, KEY_TILE[d], masked=masked) == config


def test_sm90_config_splits_are_whole_and_never_empty():
    """Over many shapes: every split the rule picks gets at least
    MIN_SPLIT_TILES key tiles, and the split only comes with a grid short of
    a wave."""
    rng = np.random.default_rng(13)
    for _ in range(500):
        d = int(rng.choice([64, 72, 256]))
        bh, n, nk = int(rng.integers(1, 40)), int(rng.integers(1, 5000)), int(rng.integers(1, 40000))
        wgs, splits = sm90_config(bh, n, nk, d, KEY_TILE[d])
        tiles = -(-nk // KEY_TILE[d])
        per = -(-tiles // splits)
        assert wgs in WAVE_COST[d]
        assert (splits - 1) * per < tiles and (splits == 1 or per >= MIN_SPLIT_TILES)
        assert splits == 1 or bh * -(-n // (64 * wgs)) < 132 * (2 if wgs == 1 else 1)


def _key_tile_list_numpy(mask, key_tile):
    """Reference of the list: a loop over tiles, in numpy."""
    b, nk = mask.shape
    tiles = -(-nk // key_tile)
    count = np.zeros(b, np.int32)
    order = np.full((b, tiles), -1, np.int32)
    flags = np.zeros((b, tiles), np.uint8)
    for e in range(b):
        for i in range(tiles):
            keys = mask[e, i * key_tile:(i + 1) * key_tile]
            if keys.any():
                order[e, count[e]], flags[e, count[e]] = i, not keys.all()
                count[e] += 1
        if count[e] == 0:
            count[e], order[e], flags[e] = tiles, np.arange(tiles), 1
    return count, order, flags


def _runs(nk, runs, b=1):
    mask = np.zeros((b, nk), bool)
    for e, a, z in runs:
        mask[e, a:z] = True
    return mask


@pytest.mark.parametrize("name,mask", [
    # whole 64-key tiles valid and empty (the memory slots)
    ("whole_tiles", _runs(6 * 64, [(0, 0, 128), (0, 256, 320), (1, 64, 384)], b=2)),
    # runs that start and end inside tiles, a ragged nk, one row all masked
    ("ragged", _runs(5 * 64 + 29, [(0, 37, 70), (0, 200, 201), (0, 300, 349), (2, 0, 349)], b=3)),
    # every key valid, ragged nk: every tile listed, none flagged
    ("all_valid", np.ones((2, 3 * 64 + 5), bool)),
    # a row whose only valid keys sit in the ragged last tile
    ("last_tile", _runs(2 * 64 + 3, [(0, 129, 131)])),
])
def test_key_tile_list_matches_numpy(name, mask):
    """The plain list against a loop in numpy, exactly; and its invariants:
    every tile with a valid key is listed, in increasing order, each flag
    says whether the tile also holds a masked key, and a row with no valid
    key lists every tile, flagged. The wrapper on a CPU mask is the plain
    version and counts no launch."""
    key_tile = 64
    count, order, flags = key_tile_list(torch.as_tensor(mask), key_tile)
    ref = _key_tile_list_numpy(mask, key_tile)
    for ours, theirs in zip((count, order, flags), ref):
        np.testing.assert_array_equal(ours.numpy(), theirs)
    assert (count.dtype, order.dtype, flags.dtype) == (torch.int32, torch.int32, torch.uint8)
    tiles = order.shape[1]
    for e in range(mask.shape[0]):
        listed = order[e, :count[e]].numpy()
        assert (np.diff(listed) > 0).all() and (order[e, count[e]:] == -1).all()
        has_valid = [mask[e, i * key_tile:(i + 1) * key_tile].any() for i in range(tiles)]
        assert set(listed) == ({i for i in range(tiles) if has_valid[i]} if any(has_valid) else set(range(tiles)))
        if not any(has_valid):
            assert (flags[e] == 1).all()
    with timing.tracing():
        before = timing.counts.get("launch.key_tiles", 0)
        for ours, theirs in zip(key_tiles(torch.as_tensor(mask), key_tile), (count, order, flags)):
            torch.testing.assert_close(ours, theirs, rtol=0, atol=0)
        assert timing.counts.get("launch.key_tiles", 0) == before


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [72, 256])
def test_masked_split_partials_combine_to_jax_stream(d, dtype, tol):
    """The plain version of a masked call's key splits: 3 splits take equal
    contiguous shares of each batch element's listed key tiles
    (`key_tile_list`), each share's (m, l, acc) from `attention_partials`
    with the mask, merged by `combine_partials`, give the JAX streaming
    kernel's output (`flash_attention_stream`, interpret mode) on the same
    numpy inputs. Batch 0 masks a whole tile and ragged runs; batch 1 keeps
    one partial tile, so two of its shares are empty; batch 2 masks every
    key (a uniform mean of V; nk is a multiple of the JAX block, so both
    sides average the same keys)."""
    key_tile, splits = KEY_TILE[d], 3
    nk = 5 * key_tile + 32
    q, k, v = _qkv(24, b=3, h=2, d=d, seed=15, nk=nk)
    mask = np.ones((3, nk), bool)
    mask[0, key_tile:2 * key_tile] = False
    mask[0, 3 * key_tile + 5:3 * key_tile + 40] = False
    mask[0, nk - 20:nk - 3] = False
    mask[1] = False
    mask[1, 2 * key_tile + 7:2 * key_tile + 30] = True
    mask[2] = False
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(tdtype) for x in (jq, jk, jv))
    tmask = torch.as_tensor(mask)
    count, order, _ = key_tile_list(tmask, key_tile)
    assert count.tolist() == [5, 1, 6]
    ours = []
    for e in range(3):
        listed = order[e, :count[e]].tolist()
        parts = []
        for s in range(splits):
            share = listed[s * len(listed) // splits:(s + 1) * len(listed) // splits]
            keys = torch.cat([torch.arange(i * key_tile, min(nk, (i + 1) * key_tile)) for i in share]) if share \
                else torch.zeros(0, dtype=torch.long)
            parts.append(attention_partials(tq[e:e + 1], tk[e:e + 1, :, keys], tv[e:e + 1, :, keys], d**-0.5,
                                            tmask[e:e + 1, keys]))
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        if e == 1:
            assert (l == 0).sum() == 2 * l[0].numel()  # two empty shares
        ours.append(combine_partials(m, l, acc, tdtype))
    ours = torch.cat(ours)
    ref = np.asarray(jax_stream(jq, jk, jv, d**-0.5, kv_mask=jnp.asarray(mask), block_q=16, block_k=32,
                                interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol)
    uniform = tv[2].float().mean(dim=1, keepdim=True).expand(-1, 24, -1).numpy()
    np.testing.assert_allclose(ours[2].float().numpy(), uniform, atol=tol)


def test_sm90_wrapper_and_launch_counts_on_cpu():
    """The sm90 kernel's wrapper at a forced configuration, with and without
    a key mask, runs the plain versions on CPU tensors, and nothing counts a
    launch."""
    q, k, v = map(torch.as_tensor, _qkv(20, b=2, h=2, seed=14, nk=33))
    mask = torch.ones((2, 33), dtype=torch.bool)
    mask[0, 5:9] = False
    with timing.tracing():
        before = dict(timing.counts)
        torch.testing.assert_close(flash_attention_sm90(q, k, v, SCALE, (3, 1)), dense_attention(q, k, v, SCALE),
                                   rtol=0, atol=0)
        torch.testing.assert_close(flash_attention_sm90(q, k, v, SCALE, (1, 4), kv_mask=mask),
                                   dense_attention_masked(q, k, v, SCALE, mask), rtol=0, atol=0)
        flash_attention(q, k, v, SCALE, single_budget=0)
        assert dict(timing.counts) == before


def _bf16(*xs):
    return [torch.as_tensor(x).to(torch.bfloat16) for x in xs], [jnp.asarray(x, jnp.bfloat16) for x in xs]


@pytest.mark.parametrize("d", [72, 256])
def test_k2_plain_matches_jax_at_sam2_head_dims(d):
    """d = 72 (Hiera-L global blocks) and d = 256 (memory self-attention),
    bf16, against the whole-K/V Pallas kernel; atol 2e-2 as for d = 64."""
    q, k, v = _qkv(40, b=1, h=2, d=d, seed=3, nk=70)
    ours_in, jax_in = _bf16(q, k, v)
    ours = flash_attention(*ours_in, d**-0.5)
    ref = np.asarray(jax_flash(*jax_in, d**-0.5, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=2e-2)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (jnp.bfloat16, 2e-2)])
def test_k3_plain_matches_jax_streaming_regime(dtype, tol):
    """single_budget=0 selects the streaming regime on both sides (K3 and
    `_flash_kernel`); 300 keys stream in 3 blocks of 112 on the JAX side."""
    q, k, v = _qkv(50, b=1, h=2, d=256, seed=4, nk=300)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    ours = flash_attention(*(torch.as_tensor(np.array(x.astype(jnp.float32))).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16) for x in (jq, jk, jv)),
        1 / 16, single_budget=0)
    ref = np.asarray(jax_flash(jq, jk, jv, 1 / 16, block_k=128, single_budget=0, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (jnp.bfloat16, 2e-2)])
def test_k4_plain_matches_jax_stream_with_empty_block_and_row(dtype, tol):
    """Batch 0: keys 32..63 (one whole 32-key block) and a ragged run
    masked; batch 1: every key masked, so every row averages V uniformly.
    nk is a multiple of the JAX block, so no padded keys enter that mean."""
    nk = 96
    q, k, v = _qkv(24, b=2, h=2, d=72, seed=5, nk=nk)
    mask = np.ones((2, nk), bool)
    mask[0, 32:64] = False
    mask[0, 70:75] = False
    mask[1] = False
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(tdtype) for x in (jq, jk, jv))
    ours = flash_attention_stream(tq, tk, tv, 72**-0.5, kv_mask=torch.as_tensor(mask))
    ref = np.asarray(jax_stream(jq, jk, jv, 72**-0.5, kv_mask=jnp.asarray(mask), block_q=16, block_k=32,
                                interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol)
    ref_dense = np.asarray(jax_dense(jq, jk, jv, 72**-0.5, kv_mask=jnp.asarray(mask)).astype(jnp.float32))
    np.testing.assert_allclose(dense_attention_masked(tq, tk, tv, 72**-0.5, torch.as_tensor(mask)).float().numpy(),
                               ref_dense, atol=tol)
    uniform = tv[1].float().mean(dim=1, keepdim=True).expand(-1, 24, -1).numpy()
    np.testing.assert_allclose(ours[1].float().numpy(), uniform, atol=tol)


def test_auto_routes_a_mask_to_k4_and_no_mask_to_flash_attention():
    q, k, v = map(torch.as_tensor, _qkv(10, b=2, h=1, d=64, seed=6, nk=30))
    mask = torch.ones((2, 30), dtype=torch.bool)
    mask[1, :20] = False
    torch.testing.assert_close(flash_attention_auto(q, k, v, SCALE, kv_mask=mask),
                               dense_attention_masked(q, k, v, SCALE, mask), rtol=0, atol=0)
    torch.testing.assert_close(flash_attention_auto(q, k, v, SCALE), dense_attention(q, k, v, SCALE),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,nk,h", [(65, 65, 2), (100, 229, 3)])
def test_k5_plain_matches_jax(n, nk, h):
    """K5's wrapper on CPU tensors (its plain version) against the biased
    streaming Pallas kernel in interpret mode and the dense reference, at
    the JAX package's own shapes (d 32, batch 2); fp32 atol 2e-5 as there."""
    from freepose_tpu.ops.attention import flash_attention_bias as jax_flash_bias

    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, h, length, 32)).astype(np.float32) for length in (n, nk, nk))
    bias = rng.normal(size=(h, n, nk)).astype(np.float32)
    scale = 32**-0.5
    ours = flash_attention_bias(*map(torch.as_tensor, (q, k, v)), scale, torch.as_tensor(bias)).numpy()
    ref = np.asarray(jax_flash_bias(*map(jnp.asarray, (q, k, v)), scale, jnp.asarray(bias), block_q=32, block_k=64,
                                    interpret=True))
    logits = np.einsum("bhnd,bhmd->bhnm", q, k) * scale + bias[None]
    w = np.exp(logits - logits.max(-1, keepdims=True))
    dense = np.einsum("bhnm,bhmd->bhnd", w / w.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(ours, ref, atol=2e-5)
    np.testing.assert_allclose(ours, dense, atol=2e-5)


def test_k5_plain_matches_jax_with_key_mask_at_ragged_n():
    """Batch 2 (the bias shared across it, read at bh % heads), d 64, a
    ragged N of 37 queries against 100 keys; batch 0 masks a ragged run of
    keys, batch 1 a whole 32-key JAX block. No row is masked whole (there
    the Pallas kernel also averages its padded keys). fp32 atol 2e-5."""
    from freepose_tpu.ops.attention import flash_attention_bias as jax_flash_bias

    q, k, v = _qkv(37, b=2, h=2, d=64, seed=8, nk=100)
    bias = np.random.default_rng(9).normal(size=(2, 37, 100)).astype(np.float32)
    mask = np.ones((2, 100), bool)
    mask[0, 40:53] = False
    mask[1, 32:64] = False
    ours = flash_attention_bias(*map(torch.as_tensor, (q, k, v)), SCALE, torch.as_tensor(bias),
                                kv_mask=torch.as_tensor(mask))
    ref = np.asarray(jax_flash_bias(*map(jnp.asarray, (q, k, v)), SCALE, jnp.asarray(bias),
                                    kv_mask=jnp.asarray(mask), block_q=16, block_k=32, interpret=True))
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)
    # The mask matters: without it the output moves by far more than the tolerance.
    unmasked = flash_attention_bias(*map(torch.as_tensor, (q, k, v)), SCALE, torch.as_tensor(bias))
    assert float((unmasked - ours).abs().max()) > 1e-2


def test_k5_cpu_tensors_run_the_plain_version_without_launch():
    q, k, v = map(torch.as_tensor, _qkv(20, b=2, h=2, seed=10, nk=30))
    bias = torch.as_tensor(np.random.default_rng(11).normal(size=(2, 20, 30)).astype(np.float32))
    with timing.tracing():
        before = timing.counts.get("launch.k5", 0)
        out = flash_attention_bias_auto(q, k, v, SCALE, bias)
        torch.testing.assert_close(out, dense_attention_bias(q, k, v, SCALE, bias), rtol=0, atol=0)
        assert timing.counts.get("launch.k5", 0) == before
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        flash_attention_bias(*(t.to("meta") for t in (q, k, v)), SCALE, bias.to("meta"))


@pytest.mark.parametrize("bh", [1, 2, 16, 32, 48, 200])
@pytest.mark.parametrize("n,nk", [(577, 577), (33, 33), (1, 1), (37, 100), (577, 4096), (4096, 65)])
def test_k5_config_is_a_build_with_whole_splits(bh, n, nk):
    """The K5 rule picks a split count that gives every split a non-empty,
    equal share of the 64-key tiles (the last one ragged), as the kernel
    computes them; a cached, pure function."""
    splits = k5_config(bh, n, nk, 132)
    assert isinstance(splits, int) and splits >= 1
    tiles = -(-nk // K5_KEY_TILE)
    per = -(-tiles // splits)
    assert splits <= tiles and -(-tiles // per) == splits
    assert k5_config(bh, n, nk, 132) == splits


@pytest.mark.parametrize("splits", [2, 4])
def test_k5_key_split_partials_combine_to_jax(splits):
    """K5's key split on the CPU: equal shares of the 64-key tiles, each
    split's fp32 partials (m, l, acc; `attention_partials` with the bias),
    merged by `bias_combine` (its plain version), match the JAX biased
    attention (fp32 atol 2e-5, as the test above). Batch 0 masks a run across a share's
    edge, batch 1 every key of the last share (its partials: m = -1e30)."""
    from freepose_tpu.ops.attention import flash_attention_bias as jax_flash_bias

    q, k, v = _qkv(37, b=2, h=2, d=64, seed=13, nk=200)
    bias = np.random.default_rng(14).normal(size=(2, 37, 200)).astype(np.float32)
    mask = np.ones((2, 200), bool)
    mask[0, 100:140] = False
    mask[1, 192:] = False
    tq, tk, tv, tb, tm = map(torch.as_tensor, (q, k, v, bias, mask))
    per = -(-(-(-200 // K5_KEY_TILE)) // splits) * K5_KEY_TILE
    parts = [attention_partials(tq, tk[:, :, s:s + per], tv[:, :, s:s + per], SCALE, tm[:, s:s + per],
                                tb[:, :, s:s + per]) for s in range(0, 200, per)]
    assert len(parts) == splits
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    with timing.tracing():
        before = timing.counts.get("launch.bias_combine", 0)
        ours = bias_combine(m, l, acc).numpy()  # CPU tensors: combine_partials in fp32
        assert timing.counts.get("launch.bias_combine", 0) == before
    ref = np.asarray(jax_flash_bias(*map(jnp.asarray, (q, k, v)), SCALE, jnp.asarray(bias),
                                    kv_mask=jnp.asarray(mask), block_q=16, block_k=32, interpret=True))
    np.testing.assert_allclose(ours, ref, atol=2e-5)
    plain = flash_attention_bias(tq, tk, tv, SCALE, tb, kv_mask=tm).numpy()
    np.testing.assert_allclose(ours, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bh,n,nk,splits", [(16, 577, 577, 3), (32, 577, 577, 2), (16, 33, 33, 1), (1, 64, 64, 1)])
def test_k5_config_at_the_main_path_shapes(bh, n, nk, splits):
    """The rule's picks: 3 key splits at ZoeD_N's [1, 16, 577, 64] (its
    model fitted to the k5 phase's device times), 2 at batch 2, none where
    a split would leave blocks idle."""
    assert k5_config(bh, n, nk, 132) == splits

