"""Flash attention: the Hopper CUDA kernel, its plain version and its wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel (``nvblox_mindmap_tpu/ops/flash_attention.py``, ``_flash_kernel``
called from ``flash_attention``): forward-only streaming-softmax attention
over pre-scaled q (B, H, L, D) and k, v (B, H, S, D) with an optional (B, S)
inclusion key mask (True = valid key). Rows with no valid key come out as
exact zeros. The source's header says what bounds it on the H100 and what
its design does about that; the TPU-only padding of D to 128 and of L, S to
512-blocks is gone (the kernel pads D to 16, 32 or 64 in registers and masks
the ragged key tile itself).

``flash_attention`` picks by device: a CPU tensor goes to
``flash_attention_reference``, the same function in plain torch; a CUDA
tensor launches the kernel or raises. There is no fallback between the two.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e9
MAX_HEAD_DIM = 64


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain torch version of the kernel, with the same exact-zero rule.

    Args:
        q: (B, H, L, D) queries, already scaled by 1/sqrt(D_head).
        k, v: (B, H, S, D).
        key_padding_mask: optional (B, S) bool, True = VALID key.

    Returns:
        (B, H, L, D).
    """
    s = torch.einsum("bhld,bhsd->bhls", q, k)
    if key_padding_mask is None:
        valid = torch.ones(s.shape[-1], dtype=q.dtype, device=q.device)
    else:
        valid = key_padding_mask[:, None, None, :].to(q.dtype)
        s = torch.where(key_padding_mask[:, None, None, :], s, NEG_INF)
    # The kernel's running max starts at NEG_INF, so it never falls below it.
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhls,bhsd->bhld", p, v)
    return out / torch.where(l > 0, l, torch.ones_like(l))


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from nvblox_mindmap_torch.ops import _build

        lib = _build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(q, k, v, key_padding_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, L, D) / (B, H, S, D)")
    B, H, L, D = q.shape
    S = k.shape[2]
    if k.shape != (B, H, S, D) or v.shape != (B, H, S, D):
        raise ValueError(
            f"k, v must be {(B, H, S, D)}, got {tuple(k.shape)} and "
            f"{tuple(v.shape)}"
        )
    if key_padding_mask is not None and key_padding_mask.shape != (B, S):
        raise ValueError(
            f"key_padding_mask must be {(B, S)}, got "
            f"{tuple(key_padding_mask.shape)}"
        )
    tensors = [q, k, v] + ([] if key_padding_mask is None else [key_padding_mask])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention inputs must share one device")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention over pre-scaled q/k/v (see module docstring).

    CPU tensors run ``flash_attention_reference``; CUDA tensors run the
    kernel, which takes contiguous fp32 q/k/v, a contiguous bool mask and
    head dims up to 64, and raises on anything else.
    """
    _check(q, k, v, key_padding_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    tensors = [q, k, v]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the flash attention kernel takes fp32 q, k, v")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the flash attention kernel takes contiguous q, k, v")
    B, H, L, D = q.shape
    S = k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(
            f"the flash attention kernel takes head dims up to {MAX_HEAD_DIM}, "
            f"got {D}"
        )
    mask_ptr = None
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool:
            raise TypeError("key_padding_mask must be bool (True = valid key)")
        if not key_padding_mask.is_contiguous():
            raise ValueError("key_padding_mask must be contiguous")
        mask_ptr = key_padding_mask.data_ptr()
    out = torch.empty_like(q)
    if L == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            out.data_ptr(), B, H, L, S, D, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
