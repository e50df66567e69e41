"""Positional encodings: sinusoidal time embedding and rotary 3D encodings.

Port of ``nvblox_mindmap_tpu/ops/positional.py``:

- ``sinusoidal_pos_emb``: transformer timestep embedding, exp-spaced
  frequencies, (sin || cos).
- ``rotary_pe_1d``: the rotary code of scalar positions over the whole
  feature dim F (F//2 frequencies, duplicated pairwise).
- ``rotary_pe_3d``: XYZ rotary encoding. The feature dim F is split into
  three bands of F//3 (one per axis); each band holds F//6 frequencies
  duplicated pairwise (interleaved) so that ``embed_rotary`` rotates
  adjacent (even, odd) channel pairs. Output (..., N, F, 2), channel 0 = cos,
  channel 1 = sin. The code spans the full embedding: attention applies it
  before the head split.
- ``embed_rotary``: x*cos + rot90(x)*sin, rot90 interleaving (-x_odd, x_even).
"""
from __future__ import annotations

import math

import torch


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(...,) scalar positions -> (..., dim) embeddings (sin || cos)."""
    half_dim = dim // 2
    emb_scale = math.log(10000) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=x.device) * -emb_scale
    )
    args = x[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _interleave_pairs(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., 2d) duplicating each value pairwise: a,b -> a,a,b,b."""
    return torch.repeat_interleave(x, 2, dim=-1)


def rotary_pe_1d(positions: torch.Tensor, feature_dim: int) -> torch.Tensor:
    """1D rotary code: (..., N) positions -> (..., N, F, 2) (cos, sin)."""
    div_term = torch.exp(
        torch.arange(0, feature_dim, 2, dtype=torch.float32, device=positions.device)
        * (-math.log(10000.0) / feature_dim)
    )
    args = positions[..., None].to(torch.float32) * div_term
    return torch.stack([_interleave_pairs(torch.cos(args)),
                        _interleave_pairs(torch.sin(args))], dim=-1)


def rotary_pe_3d(xyz: torch.Tensor, feature_dim: int) -> torch.Tensor:
    """3D rotary code: (..., N, 3) positions -> (..., N, F, 2) (cos, sin).

    The F axis is [x-band || y-band || z-band], each of width F//3.
    """
    if feature_dim % 6 != 0:
        raise ValueError(
            f"rotary 3D PE needs embedding_dim divisible by 6 (3 xyz bands of "
            f"sin/cos pairs), got {feature_dim}"
        )
    band = feature_dim // 3
    div_term = torch.exp(
        torch.arange(0, band, 2, dtype=torch.float32, device=xyz.device)
        * (-math.log(10000.0) / band)
    )
    args = xyz[..., None].to(torch.float32) * div_term  # (..., N, 3, band//2)
    sin = _interleave_pairs(torch.sin(args)).flatten(-2)  # (..., N, 3*band)
    cos = _interleave_pairs(torch.cos(args)).flatten(-2)
    return torch.stack([cos, sin], dim=-1)


def embed_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate channel pairs of x (..., N, F) by the phase (cos, sin)."""
    x2 = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos + x2 * sin


def apply_rotary_code(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Apply a (cos, sin) rotary code of shape (..., N, F, 2) to x (..., N, F)."""
    return embed_rotary(x, code[..., 0], code[..., 1])
