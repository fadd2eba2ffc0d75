"""Attention K2 in the PyTorch port vs the JAX package.

On the CPU the port's `flash_attention` runs its plain version
(`dense_attention`); it is held against the JAX Pallas kernel in interpret
mode and against the dense XLA path on the same numpy inputs.

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
from freepose_tpu_torch.ops.attention import dense_attention, flash_attention

SCALE = 64**-0.5


def _qkv(n, b=2, h=3, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3)]


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
    before = flash_attention.launches
    out = flash_attention(q, k, v, SCALE)
    torch.testing.assert_close(out, dense_attention(q, k, v, SCALE), rtol=0, atol=0)
    assert flash_attention.launches == before


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q, SCALE)

