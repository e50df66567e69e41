"""The card's peaks and the operation counts that the roofline and peak
shares divide by.

Every share is taken against the NVIDIA H100 SXM data sheet's dense 16-bit
tensor-core peak and its HBM3 rate, whatever kernel or precision serves the
work, so that no implementation can read above 100%: a faster legal kernel
moves the share up, never past the bound. The card's power limit is printed
beside every run's numbers.
"""
from __future__ import annotations

from typing import Callable, Optional

PEAK_FLOPS = 989e12  # dense bf16 / fp16 tensor cores (the data sheet, SXM, 700 W)
PEAK_BYTES_PER_S = 3.35e12


def attention_bound_s(B: int, H: int, L: int, S: int, D: int, elem_bytes: int,
                      valid_keys: Optional[int] = None, masked: bool = False) -> float:
    """Least time of one attention call over pre-scaled q (B, H, L, D) and
    k, v (B, H, S, D): the larger of its FLOPs at ``PEAK_FLOPS`` and its
    bytes at ``PEAK_BYTES_PER_S``. FLOPs are 4 * H * L * D per valid key
    (``valid_keys`` summed over the batch, B * S when None); bytes are q, k,
    v and a ``masked`` call's (B, S) bool mask read once and the output (as
    q) written once. Which kernel serves the call does not enter."""
    keys = B * S if valid_keys is None else valid_keys
    flops = 4.0 * H * L * D * keys
    nbytes = elem_bytes * (2 * B * H * L * D + 2 * B * H * S * D) + (B * S if masked else 0)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one ``fn()`` call as ``torch.utils.flop_counter`` counts its
    aten operations (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def peak_share_percent(flops: float, seconds: float) -> float:
    """``flops`` done in ``seconds`` as a percentage of ``PEAK_FLOPS``."""
    return 100.0 * flops / seconds / PEAK_FLOPS


def mfu_percent(run, kind: str) -> Optional[float]:
    """The reader of every ``*_mfu`` metric: one unit of ``kind``'s FLOPs
    (``run.flops``, counted once in set-up by ``count_flops``) over the mean
    unit time of the traced run outside the profiler, as a share of
    ``PEAK_FLOPS``; None off the card or without a count."""
    import statistics

    flops, times = run.flops.get(kind), run.untraced.get(kind)
    if not flops or not times or run.device.type != "cuda":
        return None
    return peak_share_percent(flops, statistics.fmean(times))

