"""Multi-head attention (torch), batch-first.

Port of ``nvblox_mindmap_tpu/ops/attention.py``. The eager path is the
oracle for every branch; the ``"flash"`` impl routes the plain case through
the flash-attention kernel (``ops/flash_attention.py``).

- The rotary 3D code is applied to q and k at *full* embedding width, before
  the head split.
- ``key_padding_mask`` is an exclusion mask (True = masked out). Masked
  logits get -1e9 instead of -inf, so a fully masked row produces uniform
  weights rather than NaN on the eager path (the flash kernel outputs exact
  zeros there instead).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.reference.ops.positional import apply_rotary_code

NEG_INF = -1e9
IMPLS = ("eager",)

# Process-wide default attention implementation, read at call time when a
# call site passes impl=None. ``models/converter.apply_inference_settings``
# sets it, mirroring the JAX package's switch.
_DEFAULT_IMPL = "eager"


def set_default_attention_impl(impl: str) -> None:
    global _DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"Unknown attention impl {impl!r}; one of {IMPLS}")
    _DEFAULT_IMPL = impl


def get_default_attention_impl() -> str:
    return _DEFAULT_IMPL


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    rotary_codes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    need_weights: bool = True,
    impl: Optional[str] = None,
    slot_competition: bool = False,
    k_mem: Optional[torch.Tensor] = None,
    v_mem: Optional[torch.Tensor] = None,
    mem_mask: Optional[torch.Tensor] = None,
    gate_logits: Optional[torch.Tensor] = None,
    return_kv: bool = False,
):
    """Scaled dot-product attention over projected q/k/v.

    Args:
        q: (B, L, E) projected queries; k, v: (B, S, E).
        num_heads: number of heads (E % num_heads == 0).
        key_padding_mask: optional (B, S) bool; True = exclude that key.
        rotary_codes: optional (q_code, k_code), each (B, L/S, E, 2).
        need_weights: also return per-head attention weights (B, H, L, S).
        slot_competition: softmax over the *query* axis (+1e-8), then
            renormalize over keys.
        k_mem / v_mem: optional (B, S_mem, E) memory keys/values, gated by
            ``gate_logits`` (num_heads,); ``mem_mask`` (B, S_mem) multiplies
            the memory weights.
        return_kv: return (out, q, k, v) with the post-rotary per-head
            (B, T, H, head_dim) q, k, v.

    Returns:
        (out (B, L, E), weights or None), or (out, q, k, v) with ``return_kv``.
    """
    if impl is None:
        impl = _DEFAULT_IMPL
    B, L, E = q.shape
    S = k.shape[1]
    if E % num_heads != 0:
        raise ValueError(f"embedding {E} is not divisible by {num_heads} heads")
    head_dim = E // num_heads

    q = q * head_dim**-0.5
    if rotary_codes is not None:
        q_code, k_code = rotary_codes
        q = apply_rotary_code(q, q_code)
        k = apply_rotary_code(k, k_code)

    qh = q.reshape(B, L, num_heads, head_dim)
    kh = k.reshape(B, S, num_heads, head_dim)
    vh = v.reshape(B, S, num_heads, head_dim)

    has_memory = gate_logits is not None and k_mem is not None and v_mem is not None
    if (k_mem is not None or v_mem is not None) and not has_memory:
        raise ValueError(
            "k_mem/v_mem require gate_logits (module: gate_attn=True) and "
            "both tensors - memory would otherwise be silently ignored"
        )
    logits = torch.einsum("blhd,bshd->bhls", qh, kh)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    if slot_competition:
        # Slots compete for keys: normalize over queries first, then make
        # each query's weights sum to one over keys.
        weights = torch.softmax(logits, dim=-2) + 1e-8
        if key_padding_mask is not None:
            # A fully -1e9 key column still softmaxes to uniform over the
            # query axis; zero masked keys before the key-axis
            # renormalization so padding cannot leak.
            weights = weights.masked_fill(key_padding_mask[:, None, None, :], 0.0)
        weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-20)
    else:
        weights = torch.softmax(logits, dim=-1)
    outh = torch.einsum("bhls,bshd->blhd", weights, vh)

    if has_memory:
        kmh = k_mem.reshape(B, -1, num_heads, head_dim)
        vmh = v_mem.reshape(B, -1, num_heads, head_dim)
        mem_w = torch.softmax(torch.einsum("blhd,bshd->bhls", qh, kmh), dim=-1)
        if mem_mask is not None:
            mem_w = mem_w * mem_mask[:, None, None, :].to(mem_w.dtype)
        mem_out = torch.einsum("bhls,bshd->blhd", mem_w, vmh)
        gate = torch.sigmoid(gate_logits).reshape(1, 1, num_heads, 1)
        outh = gate * mem_out + (1.0 - gate) * outh

    out = outh.reshape(B, L, E)
    if return_kv:
        return out, qh, kh, vh
    return out, (weights if need_weights else None)
