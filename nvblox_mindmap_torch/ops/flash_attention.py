"""Flash attention: the two Hopper CUDA kernels, their plain version and the
wrapper that picks between them.

The kernels replace the JAX package's Pallas TPU kernel
(``nvblox_mindmap_tpu/ops/flash_attention.py``, ``_flash_kernel`` called
from ``flash_attention``): forward-only streaming-softmax attention over
pre-scaled q (B, H, L, D) and k, v (B, H, S, D) with an optional (B, S)
inclusion key mask (True = valid key). Rows with no valid key come out as
exact zeros. Any head dim D, in one launch: the kernels sum q.k over D in
chunks of at most 128, and each block writes one chunk of at most 128 output
columns (``gridDim.z = ceil(D / 128)``). q, k and v may be fp32, fp16 or
bf16: the function is computed in fp32 and returned in q's dtype, as the
Pallas kernel's ``out_shape`` is (the wrapper casts 16-bit inputs to fp32 for
the kernels, and the plain version does the same). Both kernels compute that
same function:

- ``flash_attention_split`` (``csrc/flash_attention_split.cu``), for
  L <= ``SPLIT_MAX_L`` queries: one launch whose thread block cluster splits
  the keys and merges the partial softmax states in distributed shared
  memory;
- ``flash_attention_tile`` (``csrc/flash_attention_tile.cu``), for more
  queries: 32-query tiles on the tensor cores (``mma.sync`` in 3xTF32).

Each source's header says what bounds it on the H100 and what its design
does about that. The kernels read q, k, v and write the output through their
batch, head and sequence strides, so a caller holding (B, L, H, D) tensors
passes ``.transpose(1, 2)`` views and copies nothing; only the last dim must
be unit-stride. The output has q's memory layout (``torch.empty_like``).

``flash_attention`` picks by device: a CPU tensor goes to
``flash_attention_reference``, the same function in plain torch; a CUDA
tensor launches one kernel or raises. There is no fallback between the two.
``flash_attention.launches`` counts calls that launched a kernel;
``KERNEL_LAUNCHES`` counts the launches of each kernel. A launch into a CUDA
graph under capture runs nothing and counts nothing: each replay of the graph
counts its launches (``add_replayed``), which ``listing_launches`` listed as
``KernelCall``s from an eager run of the same work, and ``REPLAYED`` counts
them by call.

The kernels are forward-only (the JAX package has no flash backward either),
and an output written through a pointer has no autograd node. So
``flash_attention`` and ``run_kernel`` raise, on every device, when grad mode
is on and q, k or v requires grad: a gradient would otherwise stop at the
kernel without a word. Inference runs them under ``torch.no_grad``
(``sample_trajectory``); the train step passes ``impl="eager"``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e9
DTYPES = (torch.float32, torch.float16, torch.bfloat16)
# The split kernel serves up to this many queries (PERF.md has the
# measurement behind the choice).
SPLIT_MAX_L = 8
KERNELS = ("flash_attention_split", "flash_attention_tile")
KERNEL_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


class KernelCall(NamedTuple):
    """One kernel launch as a graph replays it: the kernel, q's (B, H, L, D),
    the keys S, q's element size as given, and the mask's valid keys summed
    over the batch (None without a mask)."""

    name: str
    q_shape: Tuple[int, int, int, int]
    keys: int
    element_size: int
    valid_keys: Optional[int]


# The launches that CUDA graph replays made, by call.
REPLAYED: "collections.Counter[KernelCall]" = collections.Counter()
# This thread's list while ``listing_launches`` runs: (name, q shape, S,
# element size, mask) of each launch.
_LISTING = threading.local()


@contextlib.contextmanager
def listing_launches() -> Iterator[List[KernelCall]]:
    """Yields a list that, when the block ends, holds the kernel launches
    this thread made inside it, in order (each counted as usual). The masks'
    valid keys are read then, which waits for the current stream."""
    outer = getattr(_LISTING, "calls", None)
    _LISTING.calls = raw = []
    calls: List[KernelCall] = []
    try:
        yield calls
    finally:
        _LISTING.calls = outer
    masks = [mask for *_, mask in raw if mask is not None]
    valid = iter(torch.stack([m.sum() for m in masks]).tolist() if masks else ())
    calls.extend(KernelCall(name, shape, keys, size, None if mask is None else next(valid))
                 for name, shape, keys, size, mask in raw)


def add_replayed(calls: Iterable[KernelCall]) -> None:
    """Counts one replay of a CUDA graph whose capture made ``calls``: each
    a kernel launch and a ``flash_attention`` call."""
    for call in calls:
        KERNEL_LAUNCHES[call.name] += 1
        REPLAYED[call] += 1
        flash_attention.launches += 1


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain torch version of both kernels, with the same exact-zero rule
    and dtype rule (computed in fp32, returned in q's dtype).

    Args:
        q: (B, H, L, D) queries, already scaled by 1/sqrt(D_head).
        k, v: (B, H, S, D).
        key_padding_mask: optional (B, S) bool, True = VALID key.

    Returns:
        (B, H, L, D).
    """
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
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
    return (out / torch.where(l > 0, l, torch.ones_like(l))).to(dtype)


def kernel_for(num_queries: int) -> str:
    """The kernel that serves a call with this many queries."""
    return KERNELS[0] if num_queries <= SPLIT_MAX_L else KERNELS[1]


_LIB: Optional[Dict[str, Callable[..., int]]] = None


def _library() -> Dict[str, Callable[..., int]]:
    """Each kernel's C entry point, built and loaded at first use."""
    global _LIB
    if _LIB is None:
        from nvblox_mindmap_torch.ops import _build

        fns = {}
        for name in KERNELS:
            fn = getattr(_build.load(name), name + "_fwd")
            # q, k, v, mask, o; B, H, L, S, D; the 64-bit batch, head and
            # sequence strides of q, k, v, o; the stream.
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_int64] * 12 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[name] = fn
        _LIB = fns
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention has no backward: call it under torch.no_grad() "
            "or use the eager attention impl (impl='eager') where gradients "
            "must flow"
        )


def run_kernel(
    name: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch kernel ``name`` on CUDA tensors and return its output.

    Takes fp32, fp16 or bf16 q, k, v with a unit-stride last dim and any
    other strides, a contiguous bool mask and any head dim (the split kernel:
    at most ``SPLIT_MAX_L`` queries), and raises on anything else. 16-bit
    inputs are cast to fp32 for the kernel, whose fp32 output is cast back to
    q's dtype.
    """
    _check(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"the flash attention kernels run on cuda, not {q.device}")
    if any(t.dtype not in DTYPES for t in (q, k, v)):
        raise TypeError(f"the flash attention kernels take q, k, v in {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(-1) != 1 and t.shape[-1] > 1 for t in (q, k, v)):
        raise ValueError(
            "the flash attention kernels take q, k, v whose last dim is "
            "unit-stride"
        )
    B, H, L, D = q.shape
    S = k.shape[2]
    if name == KERNELS[0] and L > SPLIT_MAX_L:
        raise ValueError(f"{name} takes up to {SPLIT_MAX_L} queries, got {L}")
    mask_ptr = None
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool:
            raise TypeError("key_padding_mask must be bool (True = valid key)")
        if not key_padding_mask.is_contiguous():
            raise ValueError("key_padding_mask must be contiguous")
        mask_ptr = key_padding_mask.data_ptr()
    dtype, q_size = q.dtype, q.element_size()
    q, k, v = q.float(), k.float(), v.float()
    out = torch.empty_like(q)
    if L == 0:
        return out.to(dtype)
    fn = _library()[name]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            B, H, L, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        KERNEL_LAUNCHES[name] += 1
        listing = getattr(_LISTING, "calls", None)
        if listing is not None:
            listing.append((name, (B, H, L, D), S, q_size, key_padding_mask))
    return out.to(dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention over pre-scaled q/k/v (see module docstring).

    CPU tensors run ``flash_attention_reference``; CUDA tensors run the
    kernel that ``kernel_for`` names for their number of queries (see
    ``run_kernel`` for what it takes).
    """
    _check(q, k, v, key_padding_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask)
    out = run_kernel(kernel_for(q.shape[2]), q, k, v, key_padding_mask)
    if q.shape[2] > 0 and not torch.cuda.is_current_stream_capturing():
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
