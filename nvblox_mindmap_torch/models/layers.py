"""Transformer building blocks (torch ``nn.Module``s), batch-first.

Port of the parts of ``nvblox_mindmap_tpu/models/layers.py`` that the
non-language keypose path uses:

- ``MultiheadAttention``: q/k/v/out projections around
  ``ops.attention.multi_head_attention``; rotary codes at full width.
- ``AdaLN``: zero-initialized scale/shift modulation from the diffusion
  timestep embedding (scale first, then shift).
- ``RelativeCrossAttentionLayer``: post-norm residual attention with
  optional AdaLN on the query and rotary relative position codes.
- ``FFWRelative{Cross,Self}AttentionModule``: stacks of (attention,
  feed-forward) pairs that return the per-layer outputs.

Parity notes: flax's ``LayerNorm`` uses eps 1e-6 (torch's default is 1e-5),
and ``models/weights.py`` transposes flax's (in, out) Dense kernels into
``nn.Linear``. Masks are exclusion masks (True = ignore key).
``ParallelAttention`` and ``FFWRelativeSelfCrossAttentionModule`` serve the
language paths and are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from nvblox_mindmap_torch.ops.attention import (
    get_default_attention_impl,
    multi_head_attention,
)

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LAYER_NORM_EPS)


class MultiheadAttention(nn.Module):
    """q/k/v/out projections around ``ops.attention.multi_head_attention``.

    The JAX module's slot-competition, memory-gating and ``return_kv``
    variants are off in every shipped config and are not ported; the
    functional op keeps them.
    """

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        rotary_codes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        need_weights: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        # Under the flash default the kernel cannot materialize weights:
        # drop them, as the JAX module does.
        if get_default_attention_impl() == "flash":
            need_weights = False
        out, weights = multi_head_attention(
            self.q_proj(query),
            self.k_proj(key),
            self.v_proj(value),
            num_heads=self.num_heads,
            key_padding_mask=key_padding_mask,
            rotary_codes=rotary_codes,
            need_weights=need_weights,
        )
        return self.out_proj(out), weights


class AdaLN(nn.Module):
    """Adaptive layer modulation; zero-init so it starts as identity."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        self.modulation = nn.Linear(embedding_dim, 2 * embedding_dim)
        nn.init.zeros_(self.modulation.weight)
        nn.init.zeros_(self.modulation.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (B, N, C); t: (B, C)."""
        scale, shift = self.modulation(F.silu(t)).chunk(2, dim=-1)
        return x * (1 + scale[:, None, :]) + shift[:, None, :]


class FeedforwardLayer(nn.Module):
    def __init__(self, embedding_dim: int, hidden_dim: int, use_adaln: bool = False):
        super().__init__()
        self.adaln = AdaLN(embedding_dim) if use_adaln else None
        self.linear1 = nn.Linear(embedding_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, embedding_dim)
        self.norm = layer_norm(embedding_dim)

    def forward(self, x: torch.Tensor, diff_ts: Optional[torch.Tensor] = None) -> torch.Tensor:
        if diff_ts is not None:
            x = self.adaln(x, diff_ts)
        h = self.linear2(F.relu(self.linear1(x)))
        return self.norm(x + h)


class RelativeCrossAttentionLayer(nn.Module):
    """Post-norm residual cross-attention with rotary relative positions."""

    def __init__(self, embedding_dim: int, num_heads: int, use_adaln: bool = False):
        super().__init__()
        self.adaln = AdaLN(embedding_dim) if use_adaln else None
        self.attention = MultiheadAttention(embedding_dim, num_heads)
        self.norm = layer_norm(embedding_dim)

    def forward(
        self,
        query: torch.Tensor,
        value: torch.Tensor,
        diff_ts: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        value_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        adaln_query = query if diff_ts is None else self.adaln(query, diff_ts)
        rotary = None if query_pos is None else (query_pos, value_pos)
        attn_out, weights = self.attention(
            adaln_query, value, value, rotary_codes=rotary,
            key_padding_mask=key_padding_mask,
        )
        return self.norm(query + attn_out), weights


class FFWRelativeCrossAttentionModule(nn.Module):
    """num_layers x (cross-attention, feed-forward); returns per-layer outputs."""

    def __init__(self, embedding_dim: int, num_attn_heads: int, num_layers: int,
                 use_adaln: bool = True):
        super().__init__()
        self.attn = nn.ModuleList(
            RelativeCrossAttentionLayer(embedding_dim, num_attn_heads, use_adaln)
            for _ in range(num_layers)
        )
        self.ffw = nn.ModuleList(
            FeedforwardLayer(embedding_dim, embedding_dim, use_adaln)
            for _ in range(num_layers)
        )

    def forward(
        self,
        query: torch.Tensor,
        value: torch.Tensor,
        diff_ts: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        value_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        outputs, all_weights = [], []
        for attn, ffw in zip(self.attn, self.ffw):
            query, weights = attn(query, value, diff_ts, query_pos, value_pos,
                                  key_padding_mask)
            query = ffw(query, diff_ts)
            outputs.append(query)
            all_weights.append(weights)
        return outputs, all_weights


class FFWRelativeSelfAttentionModule(FFWRelativeCrossAttentionModule):
    """num_layers x (self-attention, feed-forward); returns per-layer outputs."""

    def forward(
        self,
        query: torch.Tensor,
        diff_ts: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
    ) -> List[torch.Tensor]:
        outputs = []
        for attn, ffw in zip(self.attn, self.ffw):
            query, _ = attn(query, query, diff_ts, query_pos, query_pos,
                            key_padding_mask)
            query = ffw(query, diff_ts)
            outputs.append(query)
        return outputs
