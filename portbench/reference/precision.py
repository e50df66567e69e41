"""The reference's arithmetic, and the control's.

The configurations state three precisions: float32 with TF32 off (the
model, and the CLIP trunk's and FPN's convolutions), bfloat16 (the RADIO
ViT's matrix products) and float16 (the map's feature pool). The control
is the reference with each lowered one step: TF32 in float32 matrix
products and convolutions, float8 (e4m3) in the ViT's matrix operands and
in the feature pool. ``arithmetic(lowered)`` sets one or the other around
a block; ``fp8`` is where the reference's code rounds.
"""
from __future__ import annotations

import contextlib

import torch

LOWERED = False
E4M3_MAX = 448.0


@contextlib.contextmanager
def arithmetic(lowered: bool):
    """The reference's precisions inside the block (``lowered`` False), or
    the control's."""
    global LOWERED
    saved = (LOWERED, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    LOWERED = lowered
    torch.backends.cuda.matmul.allow_tf32 = lowered
    torch.backends.cudnn.allow_tf32 = lowered
    try:
        yield
    finally:
        LOWERED, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float8 e4m3 holds it under one scale per tensor (its largest
    magnitude maps to e4m3's largest), back in ``x``'s dtype; ``x`` itself
    outside the control."""
    if not LOWERED:
        return x
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
