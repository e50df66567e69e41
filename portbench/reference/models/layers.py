"""Transformer building blocks (torch ``nn.Module``s), batch-first.

Port of ``nvblox_mindmap_tpu/models/layers.py``:

- ``MultiheadAttention``: q/k/v/out projections around
  ``ops.attention.multi_head_attention``; rotary codes at full width.
- ``AdaLN``: zero-initialized scale/shift modulation from the diffusion
  timestep embedding (scale first, then shift).
- ``RelativeCrossAttentionLayer``: post-norm residual attention with
  optional AdaLN on the query and rotary relative position codes.
- ``FFWRelative{Cross,Self}AttentionModule``: stacks of (attention,
  feed-forward) pairs that return the per-layer outputs.
- The language layers: ``FFWRelativeSelfCrossAttentionModule`` (self
  layers with cross-attention layers to a context interleaved at
  ``linspace(0, n_self, n_cross + 1)``; the self layers take no key mask,
  and the cross layers drop the rotary codes when the context has none),
  ``ParallelAttentionLayer`` / ``ParallelAttention`` (post-norm
  cross-attention from one sequence to another, an optional feed-forward).
  Flax creates a module's parameters only when it is called, so a module
  here is built only where the flax module runs: the interleaved cross
  layers only with a context (``with_context``).

Parity notes: flax's ``LayerNorm`` uses eps 1e-6 (torch's default is 1e-5),
and ``models/weights.py`` transposes flax's (in, out) Dense kernels into
``nn.Linear``. Masks are exclusion masks (True = ignore key).

Training: ``dropout`` sits where the flax modules have ``nn.Dropout`` (after
the attention output and after each feed-forward projection; 0.0 by
default). Every ``forward`` with attention takes ``impl`` (``None`` reads the
process-wide default), so a train step can pass ``"eager"`` whatever
inference installed. ``set_layer_checkpointing`` wraps each (attention,
feed-forward) layer of the stacks in ``torch.utils.checkpoint``.
``init_as_flax_`` gives a module the flax initialisers.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.ops.attention import (
    get_default_attention_impl,
    multi_head_attention,
)

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default
# The std of a standard normal truncated to [-2, 2]: flax's truncated-normal
# initialisers divide by it so the result has the requested std.
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LAYER_NORM_EPS)


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default ``Dense`` / ``Conv`` kernel init: a normal truncated to
    two standard deviations, scaled to std 1/sqrt(fan_in)."""
    fan_in = weight[0].numel()  # (out, in, *kernel): in * kernel size
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class MultiheadAttention(nn.Module):
    """q/k/v/out projections around ``ops.attention.multi_head_attention``,
    with the JAX module's variants (part of its contract; the shipped
    configs enable none of them):

    - ``slot_competition``: softmax over the queries, then renormalize over
      the keys;
    - ``gate_attn``: a per-head ``gate_attn`` parameter (flax's
      ``normal(1.0)``) that mixes attention over the memory ``k_mem`` /
      ``v_mem`` (weighted by ``mem_mask``) into the output;
    - ``return_kv``: return ``(out_proj(out), q, k, v)`` with the post-rotary
      per-head q, k, v.

    A call with any variant takes the eager path, whatever the impl; only a
    plain call reaches the flash kernel. ``dropout`` is kept for the JAX
    module's signature, which declares it and never reads it.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 slot_competition: bool = False, gate_attn: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.slot_competition = slot_competition
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.gate_attn = nn.Parameter(torch.randn(num_heads)) if gate_attn else None

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        rotary_codes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        need_weights: bool = True,
        impl: Optional[str] = None,
        k_mem: Optional[torch.Tensor] = None,
        v_mem: Optional[torch.Tensor] = None,
        mem_mask: Optional[torch.Tensor] = None,
        return_kv: bool = False,
    ):
        """``(out, weights or None)``, or ``(out, q, k, v)`` with ``return_kv``."""
        impl = get_default_attention_impl() if impl is None else impl
        # The flash kernel cannot materialize weights: drop them, as the JAX
        # module does under its flash default.
        if impl == "flash":
            need_weights = False
        result = multi_head_attention(
            self.q_proj(query),
            self.k_proj(key),
            self.v_proj(value),
            num_heads=self.num_heads,
            key_padding_mask=key_padding_mask,
            rotary_codes=rotary_codes,
            need_weights=need_weights,
            impl=impl,
            slot_competition=self.slot_competition,
            k_mem=k_mem,
            v_mem=v_mem,
            mem_mask=mem_mask,
            gate_logits=self.gate_attn,
            return_kv=return_kv,
        )
        if return_kv:
            out, qh, kh, vh = result
            return self.out_proj(out), qh, kh, vh
        out, weights = result
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
    def __init__(self, embedding_dim: int, hidden_dim: int, use_adaln: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.adaln = AdaLN(embedding_dim) if use_adaln else None
        self.linear1 = nn.Linear(embedding_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, embedding_dim)
        self.dropout = nn.Dropout(dropout)
        self.norm = layer_norm(embedding_dim)

    def forward(self, x: torch.Tensor, diff_ts: Optional[torch.Tensor] = None) -> torch.Tensor:
        if diff_ts is not None:
            x = self.adaln(x, diff_ts)
        h = self.dropout(self.linear2(self.dropout(F.relu(self.linear1(x)))))
        return self.norm(x + h)


class RelativeCrossAttentionLayer(nn.Module):
    """Post-norm residual cross-attention with rotary relative positions."""

    def __init__(self, embedding_dim: int, num_heads: int, use_adaln: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.adaln = AdaLN(embedding_dim) if use_adaln else None
        self.attention = MultiheadAttention(embedding_dim, num_heads)
        self.dropout = nn.Dropout(dropout)
        self.norm = layer_norm(embedding_dim)

    def forward(
        self,
        query: torch.Tensor,
        value: torch.Tensor,
        diff_ts: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        value_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        adaln_query = query if diff_ts is None else self.adaln(query, diff_ts)
        rotary = None if query_pos is None else (query_pos, value_pos)
        attn_out, weights = self.attention(
            adaln_query, value, value, rotary_codes=rotary,
            key_padding_mask=key_padding_mask, impl=impl,
        )
        return self.norm(query + self.dropout(attn_out)), weights


class FFWRelativeCrossAttentionModule(nn.Module):
    """num_layers x (cross-attention, feed-forward); returns per-layer outputs.

    With ``checkpoint_layers`` set (``set_layer_checkpointing``), each layer
    runs under ``torch.utils.checkpoint`` while gradients are recorded: its
    activations are recomputed in the backward pass instead of kept.
    """

    def __init__(self, embedding_dim: int, num_attn_heads: int, num_layers: int,
                 use_adaln: bool = True, dropout: float = 0.0):
        super().__init__()
        self.checkpoint_layers = False
        self.attn = nn.ModuleList(
            RelativeCrossAttentionLayer(embedding_dim, num_attn_heads, use_adaln, dropout)
            for _ in range(num_layers)
        )
        self.ffw = nn.ModuleList(
            FeedforwardLayer(embedding_dim, embedding_dim, use_adaln, dropout)
            for _ in range(num_layers)
        )

    def _layer(self, i, query, value, diff_ts, query_pos, value_pos, key_padding_mask, impl):
        query, weights = self.attn[i](query, value, diff_ts, query_pos, value_pos,
                                      key_padding_mask, impl)
        return self.ffw[i](query, diff_ts), weights

    def _stack(self, query, value, diff_ts, query_pos, value_pos, key_padding_mask, impl):
        """The layers in turn; ``value`` None attends to the running query."""
        outputs, all_weights = [], []
        for i in range(len(self.attn)):
            args = (i, query, query if value is None else value, diff_ts, query_pos,
                    value_pos, key_padding_mask, impl)
            if self.checkpoint_layers and torch.is_grad_enabled():
                query, weights = checkpoint(self._layer, *args, use_reentrant=False)
            else:
                query, weights = self._layer(*args)
            outputs.append(query)
            all_weights.append(weights)
        return outputs, all_weights

    def forward(
        self,
        query: torch.Tensor,
        value: torch.Tensor,
        diff_ts: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        value_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
    ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        return self._stack(query, value, diff_ts, query_pos, value_pos, key_padding_mask,
                           impl)


class FFWRelativeSelfAttentionModule(FFWRelativeCrossAttentionModule):
    """num_layers x (self-attention, feed-forward); returns per-layer outputs."""

    def forward(
        self,
        query: torch.Tensor,
        diff_ts: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
    ) -> List[torch.Tensor]:
        return self._stack(query, None, diff_ts, query_pos, query_pos, key_padding_mask,
                           impl)[0]


class FFWRelativeSelfCrossAttentionModule(nn.Module):
    """Self-attention layers with cross-attention layers to a context
    interleaved at evenly spaced indices; both share the AdaLN timestep
    conditioning. Flax names: ``self_{i}``, ``cross_{i}``, ``ffw_{i}``.

    The cross layers exist only ``with_context`` (the flax module creates
    them only when it is called with one); the self layers attend without a
    key mask.
    """

    def __init__(self, embedding_dim: int, num_attn_heads: int, num_self_attn_layers: int,
                 num_cross_attn_layers: int, use_adaln: bool = True, dropout: float = 0.0,
                 with_context: bool = True):
        super().__init__()
        self.checkpoint_layers = False
        self.num_self_attn_layers = num_self_attn_layers
        self.with_context = with_context
        inds = np.linspace(0, num_self_attn_layers, num_cross_attn_layers + 1, dtype=np.int32)
        self.cross_inds = ({int(i) for i in inds if i < num_self_attn_layers}
                           if with_context else set())

        def layer():
            return RelativeCrossAttentionLayer(embedding_dim, num_attn_heads, use_adaln, dropout)

        for i in range(num_self_attn_layers):
            if i in self.cross_inds:
                self.add_module(f"cross_{i}", layer())
            self.add_module(f"self_{i}", layer())
        self.ffw = nn.ModuleList(
            FeedforwardLayer(embedding_dim, embedding_dim, use_adaln, dropout)
            for _ in range(num_self_attn_layers)
        )

    def _layer(self, i, query, context, diff_ts, query_pos, context_pos, key_padding_mask,
               impl):
        if i in self.cross_inds and context is not None:
            cur_query_pos = None if context_pos is None else query_pos
            query, _ = getattr(self, f"cross_{i}")(query, context, diff_ts, cur_query_pos,
                                                   context_pos, key_padding_mask, impl)
        query, _ = getattr(self, f"self_{i}")(query, query, diff_ts, query_pos, query_pos,
                                              None, impl)
        return self.ffw[i](query, diff_ts)

    def forward(
        self,
        query: torch.Tensor,
        context: Optional[torch.Tensor],
        diff_ts: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        context_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
    ) -> List[torch.Tensor]:
        if context is not None and not self.with_context:
            raise ValueError("this module was built without a context (with_context=False)")
        outputs = []
        for i in range(self.num_self_attn_layers):
            args = (i, query, context, diff_ts, query_pos, context_pos, key_padding_mask, impl)
            if self.checkpoint_layers and torch.is_grad_enabled():
                query = checkpoint(self._layer, *args, use_reentrant=False)
            else:
                query = self._layer(*args)
            outputs.append(query)
        return outputs


class ParallelAttentionLayer(nn.Module):
    """Post-norm cross-attention from ``seq1`` to ``seq2`` (``cross_12``,
    ``norm_12``), optional self-attention of ``seq1`` (``sa1``,
    ``norm_1``), and a feed-forward (``ffn_1`` / ``ffn_2``, ``norm_122``):
    the configurations upstream instantiates (vision -> language,
    trajectory -> language). Semantic positions are added to the queries
    and keys, not the values."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0,
                 self_attention1: bool = False, cross_attention1: bool = True,
                 apply_ffn: bool = True):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        if cross_attention1:
            self.cross_12 = MultiheadAttention(d_model, n_heads)
            self.norm_12 = layer_norm(d_model)
        if self_attention1:
            self.sa1 = MultiheadAttention(d_model, n_heads)
            self.norm_1 = layer_norm(d_model)
        self.apply_ffn = apply_ffn and (cross_attention1 or self_attention1)
        if self.apply_ffn:
            self.ffn_1 = nn.Linear(d_model, 4 * d_model)
            self.ffn_2 = nn.Linear(4 * d_model, d_model)
            self.norm_122 = layer_norm(d_model)

    def forward(
        self,
        seq1: torch.Tensor,
        seq2: torch.Tensor,
        seq1_key_padding_mask: Optional[torch.Tensor] = None,
        seq2_key_padding_mask: Optional[torch.Tensor] = None,
        seq1_sem_pos: Optional[torch.Tensor] = None,
        seq2_sem_pos: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
    ) -> torch.Tensor:
        def with_pos(x, pos):
            return x if pos is None else x + pos

        if hasattr(self, "cross_12"):
            attn_out, _ = self.cross_12(with_pos(seq1, seq1_sem_pos),
                                        with_pos(seq2, seq2_sem_pos), seq2,
                                        key_padding_mask=seq2_key_padding_mask, impl=impl)
            seq1 = self.norm_12(seq1 + self.dropout(attn_out))
        if hasattr(self, "sa1"):
            q1 = with_pos(seq1, seq1_sem_pos)
            attn_out, _ = self.sa1(q1, q1, seq1, key_padding_mask=seq1_key_padding_mask,
                                   impl=impl)
            seq1 = self.norm_1(seq1 + self.dropout(attn_out))
        if self.apply_ffn:
            h = self.dropout(self.ffn_2(self.dropout(F.relu(self.ffn_1(seq1)))))
            seq1 = self.norm_122(seq1 + h)
        return seq1


class ParallelAttention(nn.Module):
    """``num_layers`` ``ParallelAttentionLayer``s (flax names ``layer_{i}``)."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int, dropout: float = 0.0,
                 self_attention1: bool = False, cross_attention1: bool = True,
                 apply_ffn: bool = True):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ParallelAttentionLayer(
                d_model, n_heads, dropout, self_attention1, cross_attention1, apply_ffn))

    def forward(self, seq1: torch.Tensor, seq2: torch.Tensor,
                seq1_key_padding_mask: Optional[torch.Tensor] = None,
                seq2_key_padding_mask: Optional[torch.Tensor] = None,
                seq1_sem_pos: Optional[torch.Tensor] = None,
                seq2_sem_pos: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            seq1 = getattr(self, f"layer_{i}")(seq1, seq2, seq1_key_padding_mask,
                                               seq2_key_padding_mask, seq1_sem_pos,
                                               seq2_sem_pos, impl)
        return seq1


def set_layer_checkpointing(model: nn.Module, enabled: bool) -> None:
    """Run every attention stack of ``model`` layer by layer under
    ``torch.utils.checkpoint`` (``enabled``) or keep every activation."""
    for module in model.modules():
        if isinstance(module, (FFWRelativeCrossAttentionModule,
                               FFWRelativeSelfCrossAttentionModule)):
            module.checkpoint_layers = enabled


def init_as_flax_(model: nn.Module) -> nn.Module:
    """Initialize ``model``'s layers as the JAX package's flax modules do
    (in place): lecun-normal kernels and zero biases for every ``nn.Linear``
    and ``nn.Conv2d`` (flax's ``Dense`` / ``Conv`` defaults; CLIP's trunk
    convolutions have no bias), then
    xavier-uniform kernels for the attention projections and feed-forward
    layers, and zeros for AdaLN's modulation. LayerNorms keep ones and
    zeros; the modules' own ``nn.Parameter``s carry their flax initialisers
    from construction (``normal(1.0)`` gripper embeddings, ``normal(0.02)``
    ViT positions)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                lecun_normal_(module.weight)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for module in model.modules():
            if isinstance(module, MultiheadAttention):
                for linear in (module.q_proj, module.k_proj, module.v_proj, module.out_proj):
                    nn.init.xavier_uniform_(linear.weight)
            elif isinstance(module, FeedforwardLayer):
                for linear in (module.linear1, module.linear2):
                    nn.init.xavier_uniform_(linear.weight)
            elif isinstance(module, AdaLN):
                nn.init.zeros_(module.modulation.weight)
    return model
