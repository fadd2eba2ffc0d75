"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without a GPU.

The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit (tests/conftest.py imports JAX,
hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Attention inputs: keys and values N(0, 1), queries N(0, 3²), so that the
logits have std 3 and each row's softmax holds a few keys: outputs of O(1),
which a dropped key tile, slot or pointer set moves by O(1). Tolerances: K2,
K3 and K4 in bf16 elementwise within ops.attention.bf16_error_bound,
2^-7·(|ref| + Σ p|v| / l) (both versions round p and their output to bf16,
against different maxima); a row whose keys are all masked, which averages
V exactly in fp32 before the bf16 rounding, to 1e-4 + 1e-2·|ref|; K2 and
K5 in fp32 atol/rtol 1e-5 (the same fp32 function summed in another order).
K1 runs the plain version's fp32 operations in the same order (built
without FMA contraction): hit masks identical, depth and rgb to atol 1e-6.
The combine of the sm90 kernel's key splits against its plain version on the
same fp32 partials: 2^-6·|ref| + 1e-6, two bf16 steps (the same sums in
another order, each rounded to bf16 once, so at most one step apart). The
list kernel of a masked call against its plain version: identical.
"""
import numpy as np
import pytest
import torch

# The plain stand-ins of a kernel that reads the next head's rows, and of one
# that skips partially masked key tiles.
from chip_smoke import drops_partial_tiles, reads_next_head
from freepose_tpu_torch.geometry.rotation import template_poses
from freepose_tpu_torch.io.mesh import TriMesh, pad_mesh
from freepose_tpu_torch.ops.attention import (attention_combine, attention_partials, bf16_error_bound,
                                              combine_partials, dense_attention, dense_attention_bias,
                                              dense_attention_masked, flash_attention, flash_attention_bias,
                                              flash_attention_k2, flash_attention_k3, flash_attention_stream,
                                              flash_attention_sm90, flash_attention_tile, key_tile_list, key_tiles,
                                              launches_by_kernel, sm90_config, sm90_key_tile)
from freepose_tpu_torch.ops.attention import bias_combine
from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize
from freepose_tpu_torch.ops.rasterizer_cuda import prologue, raster_tile, raster_tile_plain

pytestmark = pytest.mark.cuda

SCALE = 64**-0.5
QUERY_STD = 3.0
K = np.asarray([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within_bound(x, ref, q, k, v, scale, mask=None) -> bool:
    """x agrees with the plain bf16 output ref within bf16_error_bound."""
    return bool(((x.float() - ref.float()).abs() <= bf16_error_bound(q, k, v, scale, ref, mask)).all())


def _qkv(n, b=2, h=4, d=64, seed=3, nk=None):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=std, size=(b, h, length, d)).astype(np.float32)
            for std, length in ((QUERY_STD, n), (1.0, nk or n), (1.0, nk or n))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [905, 37, 64])
def test_k2_matches_plain(cuda, dtype, n):
    q, k, v = (torch.as_tensor(x, device=cuda).to(dtype) for x in _qkv(n))
    before = flash_attention_k2.launches
    out = flash_attention(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert flash_attention_k2.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = dense_attention(q, k, v, SCALE)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert _within_bound(out, ref, q, k, v, SCALE)


@pytest.mark.parametrize("d", [72, 256])
@pytest.mark.parametrize("n,nk", [(4096, 4096), (37, 100), (130, 64)])
def test_k2_head_dims_match_plain(cuda, d, n, nk):
    """The Hiera-L global-block (d = 72) and memory self-attention (d = 256)
    head dims, at their 4096-token shape and at ragged lengths, on the sm90
    kernel."""
    b, h = (1, 8) if d == 72 else (2, 1)
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(n, b, h, d, nk=nk))
    before, by_kernel = flash_attention_k2.launches, launches_by_kernel["sm90"]
    out = flash_attention_k2(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert flash_attention_k2.launches == before + 1 and launches_by_kernel["sm90"] == by_kernel + 1
    ref = dense_attention(q, k, v, d**-0.5)
    assert _within_bound(out, ref, q, k, v, d**-0.5)


@pytest.mark.parametrize("d", [64, 72, 256])
def test_k3_matches_plain(cuda, d):
    """K3 through flash_attention's streaming regime (single_budget=0)."""
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(300, 1, 2, d, nk=6144 + 7))
    before = flash_attention_k3.launches
    out = flash_attention(q, k, v, d**-0.5, single_budget=0)
    torch.cuda.synchronize()
    assert flash_attention_k3.launches == before + 1
    assert _within_bound(out, dense_attention(q, k, v, d**-0.5), q, k, v, d**-0.5)


def _slot_mask(b, nk, cuda):
    """Batch 0: keys of whole 4096-key slots masked (whole key tiles empty)
    and a ragged run; batch 1: every key masked (uniform mean of V)."""
    mask = torch.ones((b, nk), dtype=torch.bool, device=cuda)
    mask[0, 4096:3 * 4096] = False
    mask[0, nk - 37:nk - 5] = False
    mask[1] = False
    return mask


@pytest.mark.parametrize("d", [64, 72, 256])
def test_k4_matches_plain(cuda, d):
    nk = 3 * 4096 + 64 + 5
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(200, 2, 2, d, nk=nk))
    mask = _slot_mask(2, nk, cuda)
    before, sm90, lists = flash_attention_stream.launches, launches_by_kernel["sm90"], key_tiles.launches
    out = flash_attention_stream(q, k, v, d**-0.5, kv_mask=mask)
    torch.cuda.synchronize()
    assert (flash_attention_stream.launches, launches_by_kernel["sm90"], key_tiles.launches) == \
        (before + 1, sm90 + 1, lists + 1)
    ref = dense_attention_masked(q, k, v, d**-0.5, mask)
    assert _within_bound(out, ref, q, k, v, d**-0.5, mask)
    uniform = v[1].float().mean(dim=1, keepdim=True).expand(-1, 200, -1)
    torch.testing.assert_close(out[1].float(), uniform, atol=1e-4, rtol=1e-2)


def _ragged_runs(b, nk, cuda):
    """Valid runs that start and end inside key tiles, in every batch
    element: partially masked tiles next to full and empty ones."""
    mask = torch.zeros((b, nk), dtype=torch.bool, device=cuda)
    for e in range(b):
        for a, z in ((37 + e, 300), (1000, 1003), (2100 + 5 * e, nk - 11)):
            mask[e, a:z] = True
        mask[e, 2500:2570] = False
    return mask


@pytest.mark.parametrize("d,config", [(64, (1, 1)), (64, (3, 1)), (72, (1, 1)), (72, (2, 2)), (72, (3, 3)),
                                      (256, (2, 1)), (256, (2, 4))])
def test_k4_builds_on_ragged_runs(cuda, d, config):
    """Each build of the masked kernel, with and without key splits, on
    ragged mask runs and a ragged nk, two heads: within the bound, and the
    tile kernel on the same inputs too; the plain stand-in of a kernel that
    treats partially masked tiles as empty breaks it."""
    nk = 3000 + 13
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(333, 2, 2, d, nk=nk, seed=11))
    mask = _ragged_runs(2, nk, cuda)
    out = flash_attention_sm90(q, k, v, d**-0.5, config, kv_mask=mask)
    tile = flash_attention_tile(q, k, v, d**-0.5, kv_mask=mask)
    torch.cuda.synchronize()
    ref = dense_attention_masked(q, k, v, d**-0.5, mask)
    assert _within_bound(out, ref, q, k, v, d**-0.5, mask)
    assert _within_bound(tile, ref, q, k, v, d**-0.5, mask)
    wrong = dense_attention_masked(q, k, v, d**-0.5, drops_partial_tiles(mask, sm90_key_tile(d)))
    assert not _within_bound(wrong, ref, q, k, v, d**-0.5, mask)


def test_k4_split_with_an_empty_share(cuda):
    """Batch 1 lists 2 key tiles and the call takes 6 splits, so 4 of its
    shares are empty: they write m = -1e30, l = 0, acc = 0 and the combine
    weighs them 0. Batch 0 masks every key (a uniform mean of V)."""
    nk = 40 * 64 + 9
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(130, 2, 1, 256, nk=nk, seed=12))
    mask = torch.zeros((2, nk), dtype=torch.bool, device=cuda)
    mask[1, 64 * 7 + 3:64 * 8 + 60] = True
    assert key_tile_list(mask, 64)[0].tolist() == [41, 2]
    before = attention_combine.launches
    out = flash_attention_sm90(q, k, v, 1 / 16, (2, 6), kv_mask=mask)
    torch.cuda.synchronize()
    assert attention_combine.launches == before + 1
    ref = dense_attention_masked(q, k, v, 1 / 16, mask)
    assert _within_bound(out, ref, q, k, v, 1 / 16, mask)
    uniform = v[0].float().mean(dim=1, keepdim=True).expand(-1, 130, -1)
    torch.testing.assert_close(out[0].float(), uniform, atol=1e-4, rtol=1e-2)


@pytest.mark.parametrize("key_tile", [64, 128])
@pytest.mark.parametrize("name", ["slots", "ragged", "all_masked", "all_valid"])
def test_key_tiles_kernel_matches_plain(cuda, name, key_tile):
    """The list kernel against key_tile_list on the same mask: identical
    counts, tile lists and flags (also past the counts)."""
    nk = 7 * 4096 + 64
    if name == "slots":
        mask = _slot_mask(2, nk, cuda)
    elif name == "ragged":
        mask = _ragged_runs(3, nk - 27, cuda)
    else:
        mask = torch.full((2, 300 * key_tile + 1), name == "all_valid", dtype=torch.bool, device=cuda)
    before = key_tiles.launches
    ours = key_tiles(mask, key_tile)
    torch.cuda.synchronize()
    assert key_tiles.launches == before + 1
    for x, y in zip(ours, key_tile_list(mask, key_tile)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_k4_at_the_memory_cross_attention_shape(cuda):
    """2 objects, 4096 queries, 7 x 4096 + 16 x 4 keys at d = 256; object 1
    has only its conditioning slot and 3 pointers. The tolerance fails a
    kernel that drops the pointer tokens or one memory slot."""
    nk = 7 * 4096 + 64
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(4096, 2, 1, 256, nk=nk))
    mask = torch.ones((2, nk), dtype=torch.bool, device=cuda)
    mask[1, 4096:7 * 4096] = False
    mask[1, 7 * 4096 + 12:] = False
    out = flash_attention_stream(q, k, v, 1 / 16, kv_mask=mask)
    ref = dense_attention_masked(q, k, v, 1 / 16, mask)
    torch.cuda.synchronize()
    assert _within_bound(out, ref, q, k, v, 1 / 16, mask)
    no_pointers, no_slot = mask.clone(), mask.clone()
    no_pointers[:, 7 * 4096:] = False
    no_slot[0, 4096:2 * 4096] = False
    for wrong in (no_pointers, no_slot):
        assert not _within_bound(dense_attention_masked(q, k, v, 1 / 16, wrong), ref, q, k, v, 1 / 16, mask)


@pytest.mark.parametrize("d", [64, 72, 256])
@pytest.mark.parametrize("n", [905, 37, 64, 4096])
def test_sm90_matches_plain(cuda, d, n):
    """The wgmma + TMA kernel through K2 (n = nk), and the previous design
    (the tile kernel) on the same inputs; the launch is counted as sm90."""
    b, h = (2, 4) if d != 256 else (2, 1)
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(n, b, h, d))
    before = dict(launches_by_kernel)
    out = flash_attention_k2(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert launches_by_kernel["sm90"] == before["sm90"] + 1 and launches_by_kernel["tile"] == before["tile"]
    ref = dense_attention(q, k, v, d**-0.5)
    assert out.shape == q.shape and _within_bound(out, ref, q, k, v, d**-0.5)
    assert _within_bound(flash_attention_tile(q, k, v, d**-0.5), ref, q, k, v, d**-0.5)


@pytest.mark.parametrize("config", [(1, 1), (3, 1)])
@pytest.mark.parametrize("b", [1, 2, 4])
def test_sm90_d64_builds_at_the_crop_batches(cuda, config, b):
    """Each d 64 build (64-row or 192-row blocks) at the paths' crop batches
    [b, 16, 905, 64], whichever the split rule picks there: 8 key tiles wrap
    the 3-stage ring."""
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(905, b, 16))
    out = flash_attention_sm90(q, k, v, SCALE, config)
    torch.cuda.synchronize()
    assert _within_bound(out, dense_attention(q, k, v, SCALE), q, k, v, SCALE)


@pytest.mark.parametrize("config", [(1, 1), (2, 1), (3, 1), (3, 3)])
@pytest.mark.parametrize("n", [4096, 333])
def test_sm90_d72_builds(cuda, config, n):
    """Each d 72 build (64-, 128- or 192-row blocks, and 192-row blocks with
    3 key splits) at the Hiera-L global shape [1, 8, 4096, 72] and at a
    ragged n = nk: the tails' zero columns 72-79 add nothing, and the
    output's columns stop at 72."""
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(n, 1, 8, 72))
    out = flash_attention_sm90(q, k, v, 72**-0.5, config)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    assert _within_bound(out, dense_attention(q, k, v, 72**-0.5), q, k, v, 72**-0.5)


@pytest.mark.parametrize("d", [64, 72, 256])
def test_sm90_ragged_key_count(cuda, d):
    """nk no multiple of the key tile (the zero-filled keys of the last tile
    must take -inf), with n != nk."""
    nk = 5 * sm90_key_tile(d) + 7
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(300, 2, 2, d, nk=nk))
    out = flash_attention_k2(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert _within_bound(out, dense_attention(q, k, v, d**-0.5), q, k, v, d**-0.5)


@pytest.mark.parametrize("d", [64, 72, 256])
def test_sm90_heads_do_not_read_each_other(cuda, d):
    """Several heads with a ragged n = nk, each head's K and V offset (V by 8
    per head), so that reading the next head's rows into a ragged tile would
    break the bound: the kernel stays within it, the stand-in of such a
    kernel does not."""
    b, h, n = 2, 3, 3 * sm90_key_tile(d) + 29
    q, k, v = (torch.as_tensor(x, device=cuda) for x in _qkv(n, b, h, d, seed=9))
    offset = torch.arange(b * h, device=cuda, dtype=torch.float32).reshape(b, h, 1, 1)
    q, k, v = q.bfloat16(), (k + 0.5 * offset).bfloat16(), (v + 8.0 * offset).bfloat16()
    out = flash_attention_k2(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    ref = dense_attention(q, k, v, d**-0.5)
    assert _within_bound(out, ref, q, k, v, d**-0.5)
    assert not _within_bound(reads_next_head(q, k, v, d**-0.5, sm90_key_tile(d)), ref, q, k, v, d**-0.5)


def test_sm90_k3_shape_with_its_key_split(cuda):
    """K3 at [1, 1, 4096, 256] x 6,144 keys: 4 key splits merged by the
    combine kernel."""
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(4096, 1, 1, 256, nk=6144))
    assert sm90_config(1, 4096, 6144, 256, sm90_key_tile(256)) == (2, 4)
    before = (flash_attention_k3.launches, launches_by_kernel["sm90"], attention_combine.launches)
    out = flash_attention(q, k, v, 1 / 16, single_budget=0)
    torch.cuda.synchronize()
    assert (flash_attention_k3.launches, launches_by_kernel["sm90"], attention_combine.launches) == \
        tuple(x + 1 for x in before)
    assert _within_bound(out, dense_attention(q, k, v, 1 / 16), q, k, v, 1 / 16)


def test_combine_kernel_matches_plain(cuda):
    """The combine kernel against combine_partials on the same fp32 partials
    of 3 key ranges at d 256; dropping a split breaks the tolerance."""
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(333, 2, 1, 256, nk=1000))
    parts = [attention_partials(q, k[:, :, a:a + 384], v[:, :, a:a + 384], 1 / 16) for a in (0, 384, 768)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    before = attention_combine.launches
    out = attention_combine(m, l, acc)
    torch.cuda.synchronize()
    assert attention_combine.launches == before + 1 and out.dtype == torch.bfloat16
    ref = combine_partials(m, l, acc)
    allowed = 2.0**-6 * ref.float().abs() + 1e-6
    assert bool(((out.float() - ref.float()).abs() <= allowed).all())
    assert not bool(((combine_partials(m[1:], l[1:], acc[1:]).float() - ref.float()).abs() <= allowed).all())


def test_k2_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim other than 64, 72, 256
        flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(), q[..., :32].contiguous(), SCALE)
    with pytest.raises(ValueError):  # not contiguous
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), SCALE)
    with pytest.raises(ValueError):  # device mismatch
        flash_attention(q, q.cpu(), q, SCALE)
    with pytest.raises(TypeError):  # fp16 is not a K2 dtype
        flash_attention(q.half(), q.half(), q.half(), SCALE)
    with pytest.raises(ValueError):  # fp32 runs at d = 64 only
        flash_attention_k2(*(torch.zeros((1, 1, 8, 72), device=cuda),) * 3, SCALE)
    with pytest.raises(TypeError):  # the streaming kernel is bf16 only
        flash_attention_stream(q.float(), q.float(), q.float(), SCALE, kv_mask=torch.ones((1, 8), device=cuda))
    with pytest.raises(ValueError):  # a mask per batch element, not per (batch, head)
        flash_attention_stream(q, q, q, SCALE, kv_mask=torch.ones((2, 8), dtype=torch.bool, device=cuda))


def _k5_inputs(cuda, b, n, masked, seed=7):
    q, k, v = (torch.as_tensor(x, device=cuda) for x in _qkv(n, b, 16, 64, seed=seed))
    bias = torch.randn((16, n, n), generator=torch.Generator(device=cuda).manual_seed(seed), device=cuda)
    mask = None
    if masked:  # batch 0 loses a ragged run of keys, batch 1 (if any) every key (a uniform mean of V)
        mask = torch.ones((b, n), dtype=torch.bool, device=cuda)
        mask[0, n // 6 : n // 3 + 1] = False
        mask[1:] = False
    return q, k, v, bias, mask


def _k5_check(out, q, k, v, bias, mask):
    ref = dense_attention_bias(q, k, v, SCALE, bias, mask)
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    if q.shape[2] > 1:  # with one key the softmax is 1 whatever the bias
        for wrong in (None, bias.roll(1, dims=0)):
            x = dense_attention_bias(q, k, v, SCALE, wrong, mask)
            assert not torch.allclose(x, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [577, 33, 1])
def test_k5_matches_plain(cuda, n, b, masked):
    """The ZoeD_N shape [b, 16, 577, 64] fp32 with a [16, 577, 577] bias
    N(0, 1), and ragged n = 33 and 1, at the key-split count `k5_config`
    picks; b = 2 shows the bias read at bh % heads. The plain version
    without the bias, or with the next head's, fails the tolerance."""
    q, k, v, bias, mask = _k5_inputs(cuda, b, n, masked)
    before = flash_attention_bias.launches
    out = flash_attention_bias(q, k, v, SCALE, bias, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_attention_bias.launches == before + 1
    _k5_check(out, q, k, v, bias, mask)


@pytest.mark.parametrize("n,splits", [(577, 1), (577, 2), (577, 3), (577, 4), (130, 1), (130, 2), (130, 3)])
def test_k5_builds_and_splits(cuda, n, splits):
    """Each key-split count the rule can pick (up to K5_MAX_SPLITS, at most
    one per key tile), forced, batch 2 with the mask, against the plain
    version; with splits the combine kernel runs in the same call and is
    counted."""
    q, k, v, bias, mask = _k5_inputs(cuda, 2, n, True, seed=11)
    before = bias_combine.launches
    out = flash_attention_bias(q, k, v, SCALE, bias, kv_mask=mask, splits=splits)
    torch.cuda.synchronize()
    assert bias_combine.launches == before + (splits > 1)
    _k5_check(out, q, k, v, bias, mask)


def test_k5_combine_kernel_matches_plain(cuda):
    """K5's combine alone against `combine_partials` in fp32 on the plain
    partials of the ZoeD_N shape's 3 key shares (with the bias and the
    mask); dropping a split fails the tolerance."""
    q, k, v, bias, mask = _k5_inputs(cuda, 2, 577, True, seed=5)
    parts = [attention_partials(q, k[:, :, a:a + 256], v[:, :, a:a + 256], SCALE, mask[:, a:a + 256],
                                bias[..., a:a + 256]) for a in range(0, 577, 256)]
    m, l, acc = (torch.stack(x).contiguous() for x in zip(*parts))
    before = bias_combine.launches
    out = bias_combine(m, l, acc)
    torch.cuda.synchronize()
    assert bias_combine.launches == before + 1
    ref = combine_partials(m, l, acc, torch.float32)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out, dense_attention_bias(q, k, v, SCALE, bias, mask), atol=1e-5, rtol=1e-5)
    assert not torch.allclose(combine_partials(m[1:], l[1:], acc[1:], torch.float32), ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError):
        bias_combine(m, l, acc.double())
    with pytest.raises(ValueError):  # head dim 64
        bias_combine(m, l, acc[..., :32].contiguous())


def test_k5_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    bias = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(TypeError):  # fp32 only
        flash_attention_bias(q.bfloat16(), q.bfloat16(), q.bfloat16(), SCALE, bias)
    with pytest.raises(ValueError):  # d = 64 only
        flash_attention_bias(*(q[..., :32].contiguous(),) * 3, SCALE, bias)
    with pytest.raises(ValueError):  # bias [H, N, Nk]
        flash_attention_bias(q, q, q, SCALE, bias[:1])
    with pytest.raises(ValueError):  # bias on another device
        flash_attention_bias(q, q, q, SCALE, bias.cpu())
    with pytest.raises(ValueError):  # a key mask per batch element
        flash_attention_bias(q, q, q, SCALE, bias, kv_mask=torch.ones((2, 8), dtype=torch.bool, device=cuda))
    with pytest.raises(RuntimeError):  # one key tile cannot take two splits
        flash_attention_bias(q, q, q, SCALE, bias, splits=2)
    k5 = torch.zeros((1, 2, 320, 64), device=cuda)
    with pytest.raises(RuntimeError):  # 4 splits of 5 key tiles (2 each) would leave one empty
        flash_attention_bias(q, k5, k5, SCALE, torch.zeros((2, 8, 320), device=cuda), splits=4)


def test_k2_at_the_dinov2_b_confidence_chunk(cuda):
    """K2 at the smooth path's shape: DINOv2-B at 518² (1,374 tokens, a
    ragged 21·64 + 30 query tail), 12 heads, 8 crops + 8 renders."""
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16) for x in _qkv(1374, b=16, h=12))
    before = flash_attention_k2.launches_by_dim.get(64, 0)
    out = flash_attention(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert flash_attention_k2.launches_by_dim[64] == before + 1
    ref = dense_attention(q, k, v, SCALE)
    assert _within_bound(out, ref, q, k, v, SCALE)
    assert not _within_bound(dense_attention(q, k[:, :, :-64], v[:, :, :-64], SCALE), ref, q, k, v, SCALE)


def _cube():
    h = 0.5
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                  [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)
    return TriMesh(v, f, np.random.default_rng(5).random((8, 3)).astype(np.float32))


def _bumpy_sphere(n_lat=10, n_lon=14):
    rng = np.random.default_rng(0)
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            r = 0.4 + 0.1 * np.sin(3 * ph)
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    v = np.asarray(verts, np.float32)
    return TriMesh(v, np.asarray(faces, np.int32), rng.random((len(v), 3)).astype(np.float32))


CASES = {
    "cube": dict(mesh=_cube, z=2.5, depth_only=False, per_pose_k=False),
    "sphere": dict(mesh=_bumpy_sphere, z=1.1, depth_only=False, per_pose_k=False),
    "depth_only": dict(mesh=_bumpy_sphere, z=1.1, depth_only=True, per_pose_k=False),
    "per_pose_k": dict(mesh=_bumpy_sphere, z=1.1, depth_only=False, per_pose_k=True),
}


def _k1_inputs(cuda, case):
    k = K
    if case["per_pose_k"]:
        k = np.stack([K * np.array([[s], [s], [1.0]], np.float32) for s in (0.8, 1.0, 1.25)])
    v, c, f, valid = (torch.as_tensor(a, device=cuda) for a in pad_mesh(case["mesh"](), 256, 512))
    return v, c, f, valid, template_poses(3, z=case["z"], device=cuda), torch.as_tensor(k, device=cuda)


def _k1_check(out, ref):
    assert bool((ref[..., 0] > 0).any())
    torch.testing.assert_close(out[..., 0] > 0, ref[..., 0] > 0, rtol=0, atol=0)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_k1_matches_plain(cuda, name):
    case = CASES[name]
    v, c, f, valid, poses, k = _k1_inputs(cuda, case)
    settings = RasterSettings(resolution=64, tile=32, max_faces_per_tile=128, depth_only=case["depth_only"])
    rows, slots = prologue(v, c, f, valid, poses, k.expand(3, 3, 3), settings)
    before = raster_tile.launches
    out = raster_tile(rows, slots, 64, 32, settings.ambient, settings.depth_only)
    torch.cuda.synchronize()
    assert raster_tile.launches == before + 1
    _k1_check(out, raster_tile_plain(rows, slots, 64, 32, settings.ambient, settings.depth_only))
    # The whole renderer: kernel path ("auto" on a CUDA tensor) vs plain.
    rgb, depth = rasterize(v, c, f, valid, poses, k, settings)
    assert raster_tile.launches == before + 2
    plain = RasterSettings(**{**settings.__dict__, "backend": "xla"})
    rgb_p, depth_p = rasterize(v, c, f, valid, poses, k, plain)
    torch.testing.assert_close(depth > 0, depth_p > 0, rtol=0, atol=0)
    torch.testing.assert_close(depth, depth_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(rgb, rgb_p, rtol=0, atol=1e-6)


@pytest.mark.parametrize("depth_only", [False, True])
@pytest.mark.parametrize("tile,mcap", [(24, 128), (28, 4), (32, 512)])
def test_k1_builds_at_ragged_tiles_and_caps(cuda, depth_only, tile, mcap):
    """Tiles that do not divide 64 px (24: the last tile row and column hang
    over; 28 with a cap of 4 faces per tile, below a tile's face count, so
    the cap binds) and 32 with more slots than faces (most are -1)."""
    v, c, f, valid, poses, k = _k1_inputs(cuda, CASES["sphere"])
    settings = RasterSettings(resolution=64, tile=tile, max_faces_per_tile=mcap, depth_only=depth_only)
    rows, slots = prologue(v, c, f, valid, poses, k.expand(3, 3, 3), settings)
    out = raster_tile(rows, slots, 64, tile, settings.ambient, depth_only)
    torch.cuda.synchronize()
    _k1_check(out, raster_tile_plain(rows, slots, 64, tile, settings.ambient, depth_only))


@pytest.mark.parametrize("depth_only", [False, True])
def test_k1_at_518_with_tile_37(cuda, depth_only):
    """The track refiner's renders: 518² in 14² tiles of 37 px (190 threads
    a block), 256 slots, 8 poses with their own crop intrinsics."""
    v, c, f, valid = (torch.as_tensor(a, device=cuda) for a in pad_mesh(_bumpy_sphere(20, 28), 2048, 4096))
    ks = torch.as_tensor(np.stack([K * np.array([[s], [s], [1.0]], np.float32) * np.array([[8.0], [8.0], [1.0]],
                                                                                           np.float32)
                                   for s in np.linspace(0.8, 1.2, 8)]), device=cuda)
    ks[:, :2, 2] = 259.0
    settings = RasterSettings(resolution=518, tile=37, max_faces_per_tile=256, depth_only=depth_only)
    rows, slots = prologue(v, c, f, valid, template_poses(8, z=1.1, device=cuda), ks, settings)
    out = raster_tile(rows, slots, 518, 37, settings.ambient, depth_only)
    torch.cuda.synchronize()
    _k1_check(out, raster_tile_plain(rows, slots, 518, 37, settings.ambient, depth_only))


def test_k1_at_the_evaluation_shape(cuda):
    """The MaskRenderer's renders in eval_bop_pose: one pose at 640² (640x480
    cropped), 20² tiles of 32 px, 256 slots, depth only, LM-O's
    intrinsics; the mesh padded to the renderer's 8,192 vertices and 16,384
    faces. The MaskRenderer's own render goes through the kernel (one
    launch) and equals the plain rasterizer's on the same pose."""
    from freepose_tpu_torch.evaluation.pose_error import MaskRenderer

    mesh = _bumpy_sphere(40, 64)
    renderer = MaskRenderer(640, 480, device=cuda)
    assert renderer.backend == "device" and (renderer.settings.resolution, renderer.settings.tile) == (640, 32)
    renderer.add_object("m", TriMesh(mesh.vertices * 0.15, mesh.faces, mesh.vertex_colors))
    k = np.asarray([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]], np.float32)
    r = np.asarray([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]], np.float32)
    t = np.asarray([0.03, -0.02, 0.7], np.float32)
    before = raster_tile.launches
    depth = renderer.render_depth("m", r, t, k)
    torch.cuda.synchronize()
    assert raster_tile.launches == before + 1 and depth.shape == (480, 640)
    v, c, f, valid = renderer._meshes["m"]
    pose = torch.eye(4, device=cuda)
    pose[:3, :3], pose[:3, 3] = torch.as_tensor(r, device=cuda), torch.as_tensor(t, device=cuda)
    rows, slots = prologue(v, c, f, valid, pose[None], torch.as_tensor(k, device=cuda)[None], renderer.settings)
    assert slots.shape == (1, 400, 256)
    out = raster_tile(rows, slots, 640, 32, renderer.settings.ambient, True)
    torch.cuda.synchronize()
    ref = raster_tile_plain(rows, slots, 640, 32, renderer.settings.ambient, True)
    _k1_check(out, ref)
    torch.testing.assert_close(depth, ref[0, :480, :, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["chamfer", "chamfer_proj", "add", "adi", "proj", "mssd", "mspd"])
def test_point_errors_on_the_card_match_float64(cuda, name):
    """The BOP point errors on the card (plain float32 norms and sqrt, TF32
    off) within 1e-4 relative of a float64 reference: the expansion trick
    cancels, so nearest distances carry ~1e-5 relative rounding."""
    from scipy.spatial.transform import Rotation

    from freepose_tpu_torch.evaluation import pose_error as pe

    k = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])
    rng = np.random.default_rng(0)
    pa, pb = ((rng.normal(size=(n, 3)) * 0.06).astype(np.float32) for n in (300, 260))
    r1, r2 = Rotation.random(2, random_state=1).as_matrix()
    t1, t2 = np.array([0.01, -0.02, 0.8]), np.array([-0.03, 0.02, 0.85])

    def cam(p, r, t):
        return p.astype(np.float64) @ r.T + t

    def pix(p, r, t):
        uvw = cam(p, r, t) @ k.T
        return uvw[:, :2] / uvw[:, 2:3]

    def dists(a, b):
        return np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))

    cases = {
        "chamfer": (lambda: pe.chamfer(r1, t1, r2, t2, pa, pb, device=cuda),
                    lambda: (lambda d: d.min(1).mean() + d.min(0).mean())(dists(cam(pa, r1, t1), cam(pb, r2, t2)))),
        "chamfer_proj": (lambda: pe.chamfer_proj(r1, t1, r2, t2, k, pa, pb, device=cuda),
                         lambda: (lambda d: d.min(1).mean() + d.min(0).mean())(dists(pix(pa, r1, t1), pix(pb, r2, t2)))),
        "add": (lambda: pe.add(r1, t1, r2, t2, pa, device=cuda),
                lambda: np.linalg.norm(cam(pa, r1, t1) - cam(pa, r2, t2), axis=1).mean()),
        "adi": (lambda: pe.adi(r1, t1, r2, t2, pa, device=cuda),
                lambda: dists(cam(pa, r1, t1), cam(pa, r2, t2)).min(1).mean()),
        "proj": (lambda: pe.proj(r1, t1, r2, t2, k, pa, device=cuda),
                 lambda: np.linalg.norm(pix(pa, r1, t1) - pix(pa, r2, t2), axis=1).mean()),
        "mssd": (lambda: pe.mssd(r1, t1, r2, t2, pa, pa, device=cuda),
                 lambda: np.linalg.norm(cam(pa, r1, t1) - cam(pa, r2, t2), axis=1).max()),
        "mspd": (lambda: pe.mspd(r1, t1, r2, t2, k, pa, pa, device=cuda),
                 lambda: np.linalg.norm(pix(pa, r1, t1) - pix(pa, r2, t2), axis=1).max()),
    }
    ours, ref = (fn() for fn in cases[name])
    assert abs(ours - ref) <= 1e-4 * ref, (name, ours, ref)


def test_k1_invalid_slots_read_as_no_face(cuda):
    """A slot of -1 reads as valid = 0 in the kernel: face 0 of a quad is
    masked out, and the plain stand-in that reads slot -1 as face 0's row
    (validity included) changes the hit mask, which the kernel does not."""
    verts = torch.tensor([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], device=cuda)
    cols = torch.rand((4, 3), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]], dtype=torch.int32, device=cuda)
    poses = torch.eye(4, device=cuda)[None].clone()
    poses[0, 2, 3] = 2.0
    settings = RasterSettings(resolution=64, tile=16, max_faces_per_tile=2)
    rows, slots = prologue(verts, cols, faces, torch.tensor([False, True], device=cuda), poses,
                           torch.as_tensor(K, device=cuda).expand(1, 3, 3), settings)
    out = raster_tile(rows, slots, 64, 16, settings.ambient, False)
    torch.cuda.synchronize()
    ref = raster_tile_plain(rows, slots, 64, 16, settings.ambient, False)
    _k1_check(out, ref)
    wrong = raster_tile_plain(rows, slots.clamp(min=0), 64, 16, settings.ambient, False)
    assert bool(((wrong[..., 0] > 0) != (out[..., 0] > 0)).any())


def test_k1_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    rows = torch.zeros((2, 16, 32), device=cuda)
    slots = torch.zeros((2, 4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        raster_tile(rows.double(), slots, 16, 8, 1.0, False)
    with pytest.raises(TypeError):
        raster_tile(rows, slots.long(), 16, 8, 1.0, False)
    with pytest.raises(ValueError):  # 32 columns per face row
        raster_tile(rows[..., :16], slots, 16, 8, 1.0, False)
    with pytest.raises(ValueError):  # T = ceil(16 / 8)² = 4 tiles per pose
        raster_tile(rows, slots[:, :3], 16, 8, 1.0, False)
    with pytest.raises(ValueError):
        raster_tile(rows, slots.cpu(), 16, 8, 1.0, False)
    with pytest.raises(RuntimeError):  # a tile of 80 px takes 20 x 40 = 800 threads, more than a block's 512
        raster_tile(rows, slots, 160, 80, 1.0, False)


# The refine path on the card: the device cache's victim pick and the
# AutoRefineChain step, against the same functions on the CPU.


def test_lru_victims_on_the_card_match_the_cpu(cuda):
    from freepose_tpu_torch.pipeline.fine_cache import lru_victims

    rng = np.random.default_rng(0)
    for case in range(100):
        cap, b = int(rng.integers(8, 300)), int(rng.integers(1, 33))
        last_used = torch.as_tensor(rng.integers(-1, 8, cap + 1).astype(np.int32))
        protect = torch.as_tensor(rng.random(cap + 1) < rng.uniform(0, 0.95))
        protect[cap] = True
        real = torch.as_tensor(np.arange(b) < rng.integers(0, b + 1))
        ours = lru_victims(last_used.to(cuda), protect.to(cuda), real.to(cuda))
        torch.testing.assert_close(ours.cpu(), lru_victims(last_used, protect, real), rtol=0, atol=0)


def _refine_setup(device):
    from freepose_tpu_torch.models.dinov2 import DinoFeatureExtractor, DinoV2Config
    from freepose_tpu_torch.pipeline.online_pose_estimator import OnlinePoseEstimator
    from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank

    # Head dim 64 (fp32 K2 on the card), 84² crops: 36 patches.
    fe = DinoFeatureExtractor(DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, image_size=56), device=device)

    def fn(imgs):
        return fe(imgs, layer=2, feature_type="patch")

    renderer = TemplateRenderer(n_poses=16, resolution=84, max_vertices=256, max_faces=512,
                                settings=RasterSettings(resolution=84, tile=28, max_faces_per_tile=128),
                                device=device)
    return OnlinePoseEstimator(fn, TemplateBank(fn, renderer), renderer, n_coarse_poses=16, n_fine_poses=200,
                               n_neighbors=8, extractor=fe, feature_layer=2, fine_cache_capacity=12)


def test_auto_chain_on_the_card_matches_the_cpu(cuda):
    """AutoRefineChain with K1 and K2 on the card (pinned host copies, the
    per-step miss count read behind the query crop's ViT, in-place cache
    writes on the card) against the same chain on the CPU and against the
    serial closed loop on the card, through overflow re-dispatches. Grid
    poses identical; scores within 1e-4 (fp32 K2 against the plain
    attention; fp32 ViT sums in another order)."""
    from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain

    mesh = _bumpy_sphere()
    est_cpu = _refine_setup("cpu")
    frames = []
    for gi in (5, 6, 7, 60, 61, 5, 120, 121, 6, 7):
        rgb, depth = est_cpu.renderer.render_from_poses(mesh, est_cpu.fine_poses[gi][None])
        props, masks, boxes = est_cpu.renderer.generate_proposals(rgb, depth)
        frames.append((props[0], masks[0], boxes[0].float()))
    prev0 = est_cpu.fine_poses[5]
    runs = {}
    for device in ("cpu", cuda):
        est = est_cpu if device == "cpu" else _refine_setup(cuda)
        chain = AutoRefineChain(est, mesh, "ck", neighborhood_deg=40.0, lag=2, miss_bucket=2)
        launches = raster_tile.launches, flash_attention_k2.launches
        for i, (prop, mask, box) in enumerate(frames):
            chain.submit(prop, mask, est.renderer.k, box, 0.25, prev_pose=prev0 if i == 0 else None)
        runs[str(device)] = chain.finalize_all()
        assert chain.n_full_redispatch > 0
        if device != "cpu":
            assert raster_tile.launches > launches[0] and flash_attention_k2.launches > launches[1]
            st = chain.state
            table, grid_of = st.slot_table.cpu().numpy(), st.grid_of.cpu().numpy()
            assert table[-1] == -1 and (table < 12).all() and grid_of[12] == 200
            for gi in np.flatnonzero(table >= 0):
                assert grid_of[table[gi]] == gi
            serial, prev = [], prev0
            for prop, mask, box in frames:
                o = est.refine_cached(prop, mask, mesh, est.renderer.k, box, 0.25, prev, 40.0, cache_key="serial")
                serial.append((o.tcos[0].cpu().numpy(), float(o.scores[0])))
                prev = o.tcos[0]
            runs["serial"] = serial
    for name in (str(cuda), "serial"):
        assert len(runs[name]) == len(runs["cpu"]) == len(frames)
        for (tc, sc), (tr, sr) in zip(runs[name], runs["cpu"]):
            np.testing.assert_allclose(tc[:3, :3], tr[:3, :3], rtol=0, atol=1e-6)
            np.testing.assert_allclose(tc, tr, atol=1e-4)
            assert abs(sc - sr) < 1e-4


# The static proposal path on the card: SAM2 image masks through K2 at d 72
# against the plain attention, and the GroundingDINO-B bf16 forward.


def _boxed_image(seed: int = 0):
    """A seeded 480x640 uint8 image with 8 painted rectangles, and their boxes."""
    rng = np.random.default_rng(seed)
    image = (rng.random((480, 640, 3)) * 90).astype(np.uint8)
    boxes = []
    for i in range(8):
        x0, y0 = int(rng.integers(0, 520)), int(rng.integers(0, 380))
        x1, y1 = x0 + int(rng.integers(40, 120)), y0 + int(rng.integers(40, 100))
        image[y0:y1, x0:x1] = rng.integers(100, 255, 3)
        boxes.append([x0, y0, x1, y1])
    return image, np.asarray(boxes, np.float32)


def test_sam2_image_masks_with_k2_match_plain(cuda):
    """Sam2ImagePredictor at the production config (Hiera-L at 1024², bf16,
    the global blocks on K2 at d 72), 8 boxes as one prompt set, seeded
    random weights: the masks with every attention call on the kernels and
    on the plain versions, mean IoU >= 0.9 (bf16 sums in another order)."""
    from chip_smoke import plain_attention_auto
    from freepose_tpu_torch.models.sam2.predictor import Sam2ImagePredictor
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.scripts.common import production_sam2_config

    cfg, size = production_sam2_config(cuda)
    pred = Sam2ImagePredictor(cfg, image_size=size, device=cuda)
    image, boxes = _boxed_image()
    runs, kernel_auto = [], attention.flash_attention_auto
    for plain in (False, True):
        before = flash_attention_k2.launches
        if plain:
            attention.flash_attention_auto = plain_attention_auto
        try:
            pred.set_image(image)
            masks, iou, _ = pred.predict(box=boxes, multimask_output=False, fetch_low_res_logits=False)
        finally:
            attention.flash_attention_auto = kernel_auto
        assert (flash_attention_k2.launches > before) != plain
        assert masks.shape == (8, 1, 480, 640) and np.isfinite(iou).all()
        runs.append(masks[:, 0])
    inter = (runs[0] & runs[1]).sum(axis=(1, 2))
    union = (runs[0] | runs[1]).sum(axis=(1, 2))
    assert np.mean(np.where(union > 0, inter / np.maximum(union, 1), 1.0)) >= 0.9


def test_grounding_dino_bf16_forward_is_finite_and_repeats(cuda):
    """GroundingDINO-B (Swin-B, BERT-base, 900 queries) at 800² in bf16 on
    the card with seeded random weights: finite boxes in [0, 1], logits
    finite on the prompt's tokens and -inf past them, and a second forward
    on the same image identical, bit for bit (the query selection's tie
    order included)."""
    from freepose_tpu_torch.models.grounding_dino import GroundingDinoDetector
    from freepose_tpu_torch.scripts.common import production_gdino_config

    det = GroundingDinoDetector(production_gdino_config(cuda), device=cuda)
    image, _ = _boxed_image(1)
    (logits, boxes), (logits2, boxes2) = det.forward_images([image]), det.forward_images([image])
    assert logits.shape == (1, 900, 256) and boxes.shape == (1, 900, 4)
    assert torch.isfinite(logits[..., :4]).all() and torch.isinf(logits[..., 4:]).all()
    assert torch.isfinite(boxes).all() and float(boxes.min()) >= 0.0 and float(boxes.max()) <= 1.0
    assert torch.equal(logits, logits2) and torch.equal(boxes, boxes2)
    b1, s1 = det.detect(image, box_threshold=0.0)
    b2, s2 = det.detect(image, box_threshold=0.0)
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(s1, s2)
