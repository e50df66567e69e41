"""Binary mask operations (erosion, borders, AND-pooling downscale) in torch.

Port of ``nvblox_mindmap_tpu/ops/masks.py``: erosion is a max-pool of the
inverted mask (padding never wins the max, as ``reduce_window`` with a -inf
init); downscale is an all-reduce over ``factor x factor`` blocks. The image
path uses ``downscale_mask``; the mapper uses the other two.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def erode_mask(mask: torch.Tensor, kernel_size: int = 3, iterations: int = 1) -> torch.Tensor:
    """Erode a 2D bool mask: expand the False regions by max-pooling their complement."""
    if mask.dim() != 2:
        raise ValueError(f"erode_mask takes a 2D mask, got {tuple(mask.shape)}")
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    pad = (kernel_size - 1) // 2
    inv = (~mask).to(torch.float32)[None, None]
    for _ in range(iterations):
        inv = F.max_pool2d(inv, kernel_size, stride=1, padding=pad)
    return ~(inv[0, 0] > 0)


def get_border_mask(shape, border_percent: float, device=None) -> torch.Tensor:
    """(H, W) bool mask on ``device``, False on a border of ``border_percent``
    of each side."""
    height, width = shape[:2]
    border_h = int(border_percent * 0.01 * height)
    border_w = int(border_percent * 0.01 * width)
    mask = torch.ones((height, width), dtype=torch.bool, device=device)
    if border_h > 0 and border_w > 0:
        mask[:border_h, :] = False
        mask[-border_h:, :] = False
        mask[:, :border_w] = False
        mask[:, -border_w:] = False
    return mask


def downscale_mask(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """AND-pool a (..., H, W) bool mask by ``factor`` along the last two dims."""
    if factor <= 0:
        raise ValueError(f"factor must be positive, got {factor}")
    *lead, H, W = mask.shape
    if H % factor or W % factor:
        raise ValueError(f"mask of {H}x{W} does not divide by {factor}")
    view = mask.reshape(*lead, H // factor, factor, W // factor, factor)
    return view.all(dim=-1).all(dim=-2)
