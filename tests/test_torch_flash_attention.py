"""Torch port: flash attention's plain version vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as its own tests run it.
On the CPU the port's wrapper takes its plain version; the two CUDA kernels
are checked against that plain version on the card by
``tests/test_torch_cuda.py``. The split kernel's arithmetic (partial softmax
states over chunks of the keys, merged) is written out here in torch and
held against the Pallas kernel too. Inputs come from numpy seeds.

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
        # Wide head dims: the Pallas wrapper pads D to a multiple of 128, the
        # kernels take it in chunks of 128.
        (1, 2, 20, 70, 64, True),
        (1, 2, 3, 70, 128, True),
        (1, 2, 3, 70, 144, True),
        (1, 2, 40, 50, 192, False),
        (1, 2, 33, 40, 256, True),
    ],
)
def test_plain_version_matches_jax_kernel(B, H, L, S, D, masked):
    rng = np.random.default_rng(L * 1000 + S + D)
    q, k, v = _qkv(rng, B, H, L, S, D)
    mask = (rng.uniform(size=(B, S)) > 0.3) if masked else None
    out, ref = _both(q, k, v, mask)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16_bit_inputs_compute_in_fp32_and_keep_their_dtype(dtype):
    """16-bit q, k, v: the output is q's dtype, and equals the fp32 function
    of the same (16-bit) values, rounded once. The Pallas kernel rounds P to
    v's dtype before P.V as well, so it is held at that dtype's precision:
    rtol of two ulps at the output's magnitude."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 2, 3, 20, 50, 64)
    mask = rng.uniform(size=(2, 50)) > 0.3
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t16 = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    out = fa.flash_attention(*t16, torch.from_numpy(mask))
    assert out.dtype == tdt
    exact = fa.flash_attention(*(t.float() for t in t16), torch.from_numpy(mask))
    torch.testing.assert_close(out, exact.to(tdt), rtol=0, atol=0)
    ref = jax_flash(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                    key_padding_mask=jnp.asarray(mask), block_q=32, block_k=64,
                    interpret=True)
    assert ref.dtype == jdt
    eps = float(torch.finfo(tdt).eps)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2 * eps, atol=2 * eps * exact.abs().max().item())


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


def _split_and_merge(q, k, v, mask, n_splits):
    """The split kernel's rule on the plain version: each split of the keys
    keeps a partial (m, l, acc), m starting at -1e9; the merge rescales them
    to m = max m_i."""
    S = k.shape[2]
    per = -(-S // n_splits)
    parts = []
    for r in range(n_splits):
        lo, hi = min(S, r * per), min(S, r * per + per)
        valid = mask[:, None, None, lo:hi]
        s = torch.einsum("bhld,bhsd->bhls", q, k[:, :, lo:hi])
        s = torch.where(valid, s, fa.NEG_INF)
        m = torch.full(s.shape[:-1] + (1,), fa.NEG_INF)
        if hi > lo:
            m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m) * valid
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhls,bhsd->bhld", p, v[:, :, lo:hi])))
    m = torch.stack([m_i for m_i, _, _ in parts]).amax(0)
    l = sum(l_i * torch.exp(m_i - m) for m_i, l_i, _ in parts)
    acc = sum(a_i * torch.exp(m_i - m) for m_i, _, a_i in parts)
    return acc / torch.where(l > 0, l, torch.ones_like(l))


@pytest.mark.parametrize(
    "L,S,D,n_splits",
    [
        (1, 300, 15, 3),
        (3, 257, 9, 2),
        (6, 512, 15, 8),
        (8, 130, 32, 8),  # the last split is shorter
        (2, 5, 9, 8),  # more splits than keys: some are empty
    ],
)
def test_split_and_merge_matches_jax_kernel(L, S, D, n_splits):
    """One split wholly masked, a fully masked batch element: the merge adds
    such a split exactly 0 and the element comes out exactly 0."""
    rng = np.random.default_rng(L * 100 + S)
    B, H = 3, 2
    q, k, v = _qkv(rng, B, H, L, S, D)
    mask = rng.uniform(size=(B, S)) > 0.3
    mask[:, : -(-S // n_splits)] = False  # the first split
    mask[1] = False
    out = _split_and_merge(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(mask),
                           n_splits).numpy()
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               key_padding_mask=jnp.asarray(mask), block_q=32,
                               block_k=64, interpret=True))
    np.testing.assert_array_equal(out[1], 0.0)
    assert np.abs(out[0]).max() > 0
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_kernel_choice_by_number_of_queries():
    assert [fa.kernel_for(L) for L in (1, 2, 3, 6, 8)] == ["flash_attention_split"] * 5
    assert [fa.kernel_for(L) for L in (9, 129, 410)] == ["flash_attention_tile"] * 3
    assert set(fa.KERNEL_LAUNCHES) == set(fa.KERNELS)


def test_cpu_takes_transposed_views():
    """(B, T, H, D) views, as multi_head_attention passes them."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(2, 7, 3, 9)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, 10, 2, 3, 9)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(2, 10)) > 0.3)
    views = (q.transpose(1, 2), kv[:, :, 0].transpose(1, 2),
             kv[:, :, 1].transpose(1, 2))
    out = fa.flash_attention(*views, mask)
    ref = fa.flash_attention_reference(*(t.contiguous() for t in views), mask)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 2, 3, 8)
    k = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError, match="k, v must be"):
        fa.flash_attention(q, k, torch.zeros(1, 2, 4, 8))
    with pytest.raises(ValueError, match="key_padding_mask"):
        fa.flash_attention(q, k, k, torch.ones(1, 4, dtype=torch.bool))
