"""Torch port: every branch of multi_head_attention against the JAX function.

Same numpy inputs go through ``nvblox_mindmap_tpu.ops.attention`` (XLA
path) and ``nvblox_mindmap_torch.ops.attention`` (eager path, and the flash
impl whose CPU tensors take the kernel's plain version). Tolerance: fp32
atol 2e-5 on outputs and weights; the two sides sum in different orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvblox_mindmap_tpu.ops import attention as jattn
from nvblox_mindmap_tpu.ops.positional import rotary_pe_3d as jax_rotary
from nvblox_mindmap_torch.ops import attention as tattn
from nvblox_mindmap_torch.ops import flash_attention as fa

ATOL = 2e-5
B, L, S, E, H = 2, 5, 11, 24, 4


@pytest.fixture(autouse=True)
def restore_impl():
    yield
    tattn.set_default_attention_impl("eager")


def _inputs(seed, fully_masked_row=True):
    rng = np.random.default_rng(seed)
    x = {
        "q": rng.normal(size=(B, L, E)).astype(np.float32),
        "k": rng.normal(size=(B, S, E)).astype(np.float32),
        "v": rng.normal(size=(B, S, E)).astype(np.float32),
        "mask": rng.uniform(size=(B, S)) > 0.6,  # exclusion: True = ignore
        "k_mem": rng.normal(size=(B, 7, E)).astype(np.float32),
        "v_mem": rng.normal(size=(B, 7, E)).astype(np.float32),
        "mem_mask": (rng.uniform(size=(B, 7)) > 0.3).astype(np.float32),
        "gate": rng.normal(size=(H,)).astype(np.float32),
        "q_xyz": rng.uniform(-1, 1, size=(B, L, 3)).astype(np.float32),
        "k_xyz": rng.uniform(-1, 1, size=(B, S, 3)).astype(np.float32),
    }
    if fully_masked_row:
        x["mask"][1] = True  # -1e9 everywhere: uniform weights on both sides
    return x


BRANCHES = {
    "plain": dict(),
    "mask": dict(mask=True),
    "rotary": dict(rotary=True, mask=True),
    "no_weights": dict(mask=True, need_weights=False),
    "slot_competition": dict(mask=True, slot_competition=True),
    "slot_competition_no_mask": dict(slot_competition=True),
    "memory": dict(mask=True, memory=True),
    "memory_mem_mask": dict(memory=True, mem_mask=True, rotary=True),
    "return_kv": dict(mask=True, rotary=True, return_kv=True),
}


def _call(module, to, x, opts, impl):
    kwargs = dict(
        num_heads=H,
        key_padding_mask=to(x["mask"]) if opts.get("mask") else None,
        need_weights=opts.get("need_weights", True),
        impl=impl,
        slot_competition=opts.get("slot_competition", False),
        return_kv=opts.get("return_kv", False),
    )
    if opts.get("rotary"):
        kwargs["rotary_codes"] = (
            to(np.array(jax_rotary(jnp.asarray(x["q_xyz"]), E))),
            to(np.array(jax_rotary(jnp.asarray(x["k_xyz"]), E))),
        )
    if opts.get("memory"):
        kwargs.update(k_mem=to(x["k_mem"]), v_mem=to(x["v_mem"]),
                      gate_logits=to(x["gate"]))
        if opts.get("mem_mask"):
            kwargs["mem_mask"] = to(x["mem_mask"])
    return module.multi_head_attention(to(x["q"]), to(x["k"]), to(x["v"]), **kwargs)


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_eager_branch_matches_jax(branch):
    opts = BRANCHES[branch]
    x = _inputs(seed=len(branch))
    ref = _call(jattn, jnp.asarray, x, opts, "xla")
    out = _call(tattn, torch.from_numpy, x, opts, "eager")
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            np.testing.assert_allclose(o.numpy(), _np(r), atol=ATOL)


def test_fully_masked_row_gets_uniform_weights():
    x = _inputs(seed=1)
    _, w = _call(tattn, torch.from_numpy, x, dict(mask=True), "eager")
    torch.testing.assert_close(w[1], torch.full_like(w[1], 1.0 / S))


def test_flash_impl_matches_jax_xla(monkeypatch):
    """The flash branch (plain version on the CPU) inverts the exclusion mask
    into the kernel's inclusion mask and matches XLA where a row has at least
    one valid key."""
    x = _inputs(seed=7, fully_masked_row=False)
    opts = dict(mask=True, rotary=True, need_weights=False)
    ref, _ = _call(jattn, jnp.asarray, x, opts, "xla")
    calls = []
    real = fa.flash_attention

    def counting(*args, **kwargs):
        calls.append(kwargs.get("key_padding_mask"))
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", counting)
    out, w = _call(tattn, torch.from_numpy, x, opts, "flash")
    assert w is None and len(calls) == 1
    np.testing.assert_array_equal(calls[0].numpy(), ~x["mask"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_impl_keeps_eager_for_weights_and_variants():
    x = _inputs(seed=3)
    for opts in (dict(mask=True), dict(mask=True, slot_competition=True),
                 dict(memory=True), dict(return_kv=True)):
        eager = _call(tattn, torch.from_numpy, x, opts, "eager")
        flash = _call(tattn, torch.from_numpy, x, opts, "flash")
        for a, b in zip(eager, flash):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_impl_on_strided_views_matches_eager(monkeypatch):
    """q, k, v sliced from one fused projection (strided (B, T, E) views):
    the flash branch hands the kernel (B, H, T, D) views with a unit-stride
    last dim, copies none of them, and matches the eager path."""
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.normal(size=(B, S, 3 * E)).astype(np.float32))
    q, k, v = qkv[:, :L, :E], qkv[..., E:2 * E], qkv[..., 2 * E:]
    mask = torch.from_numpy(rng.uniform(size=(B, S)) > 0.6)
    mask[:, 0] = False  # every row keeps a valid key
    seen = []
    real = fa.flash_attention

    def spy(*args, **kwargs):
        seen.extend(args[:3])
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", spy)
    eager, _ = tattn.multi_head_attention(q, k, v, H, key_padding_mask=mask,
                                          need_weights=False, impl="eager")
    flash, w = tattn.multi_head_attention(q, k, v, H, key_padding_mask=mask,
                                          need_weights=False, impl="flash")
    assert w is None and len(seen) == 3
    for t in seen[1:]:  # k and v reach the kernel as views of qkv
        assert t.untyped_storage().data_ptr() == qkv.untyped_storage().data_ptr()
    assert all(t.stride(-1) == 1 and not t.is_contiguous() for t in seen)
    assert flash.shape == (B, L, E)
    torch.testing.assert_close(flash, eager, rtol=0, atol=ATOL)


def test_default_impl_switch():
    assert tattn.get_default_attention_impl() == "eager"
    tattn.set_default_attention_impl("flash")
    assert tattn.get_default_attention_impl() == "flash"
    with pytest.raises(ValueError, match="Unknown attention impl"):
        tattn.set_default_attention_impl("xla")


def test_memory_requires_gate():
    x = _inputs(seed=4)
    with pytest.raises(ValueError, match="gate_logits"):
        tattn.multi_head_attention(
            torch.from_numpy(x["q"]), torch.from_numpy(x["k"]),
            torch.from_numpy(x["v"]), H, k_mem=torch.from_numpy(x["k_mem"]),
            v_mem=torch.from_numpy(x["v_mem"]),
        )


def test_module_drops_weights_under_flash():
    from nvblox_mindmap_torch.models.layers import MultiheadAttention

    torch.manual_seed(0)
    mha = MultiheadAttention(E, H)
    x = _inputs(seed=5, fully_masked_row=False)
    q, k = torch.from_numpy(x["q"]), torch.from_numpy(x["k"])
    mask = torch.from_numpy(x["mask"])
    out_eager, w = mha(q, k, k, key_padding_mask=mask)
    assert w is not None and w.shape == (B, H, L, S)
    tattn.set_default_attention_impl("flash")
    with torch.no_grad():  # the kernel has no backward: it refuses under grad
        out_flash, w = mha(q, k, k, key_padding_mask=mask)
    assert w is None
    torch.testing.assert_close(out_flash, out_eager, rtol=0, atol=ATOL)
