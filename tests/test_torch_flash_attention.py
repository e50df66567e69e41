"""Torch port: flash attention's plain version vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as its own tests run it.
On the CPU the port's wrapper takes its plain version; the CUDA kernel is
checked against that plain version on the card by
``tests/test_torch_cuda.py``. Inputs come from numpy seeds.

Tolerance: fp32 atol 2e-5, as the JAX package's flash tests use: both sides
compute the same softmax in fp32, in different summation orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvblox_mindmap_tpu.ops.flash_attention import flash_attention as jax_flash
from nvblox_mindmap_torch.ops import flash_attention as fa

ATOL = 2e-5


def _qkv(rng, B, H, L, S, D):
    q = rng.normal(size=(B, H, L, D)).astype(np.float32) * D**-0.5
    k = rng.normal(size=(B, H, S, D)).astype(np.float32)
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)
    return q, k, v


def _both(q, k, v, mask, block_q=32, block_k=64):
    jmask = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               key_padding_mask=jmask, block_q=block_q,
                               block_k=block_k, interpret=True))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), tmask).numpy()
    return out, ref


@pytest.mark.parametrize(
    "B,H,L,S,D,masked",
    [
        # The JAX package's own flash cases (tests/test_flash_attention.py).
        (2, 3, 16, 64, 32, True),
        (2, 3, 100, 130, 15, True),
        (1, 2, 32, 32, 16, False),
        # Head dims of the path: 9 (fixtures) and 15 (full width).
        (2, 8, 3, 128, 9, False),
        (2, 8, 1, 128, 9, True),
        (1, 8, 33, 33, 9, True),
        (1, 8, 6, 200, 15, False),
        (2, 8, 41, 41, 15, True),
    ],
)
def test_plain_version_matches_jax_kernel(B, H, L, S, D, masked):
    rng = np.random.default_rng(L * 1000 + S + D)
    q, k, v = _qkv(rng, B, H, L, S, D)
    mask = (rng.uniform(size=(B, S)) > 0.3) if masked else None
    out, ref = _both(q, k, v, mask)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_fully_masked_rows_are_exact_zeros():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 2, 4, 6, 8)
    mask = np.ones((2, 6), bool)
    mask[0] = False
    out, ref = _both(q, k, v, mask)
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_array_equal(ref[0], 0.0)
    assert np.abs(out[1]).max() > 0
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_cpu_tensors_take_the_plain_version_without_building():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 2, 5, 7, 9))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert fa.flash_attention.launches == before
    assert fa._LIB is None  # nothing was compiled or loaded


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 2, 3, 8)
    k = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError, match="k, v must be"):
        fa.flash_attention(q, k, torch.zeros(1, 2, 4, 8))
    with pytest.raises(ValueError, match="key_padding_mask"):
        fa.flash_attention(q, k, k, torch.ones(1, 4, dtype=torch.bool))
