"""Denoising transformer head (torch, batch-first).

Port of ``nvblox_mindmap_tpu/models/diffusion_head.py``:

trajectory tokens -> [cross-attention to the instruction] -> [+ sinusoidal
traj-time PE]
  -> 2x rotary cross-attention to the full context (AdaLN-conditioned)
  -> 4x self-attention over [trajectory || FPS context]
  -> separate 2-layer rotation / position self-attention heads
  -> MLP predictors (rot 6D, pos 3, openness logit, optional head yaw).

The AdaLN signal is sinusoidal(timestep) MLP + flattened gripper-history
embedding. Empty-context samples fall back to an all-active mask with zeroed
features so softmax stays finite, branchless as in the JAX package.
``diffusion_dropout`` goes to the attention stacks, ``predictor_dropout`` to
the MLPs' hidden layer, as in the flax module. ``prediction_horizon`` is
kept for the flax module's signature, which declares it and never reads it
(the trajectory's length comes from its input).

Language: with ``use_instruction`` the trajectory tokens first cross-attend
to the instruction (``traj_lang_attention``, one layer, no feed-forward,
the traj-time code added to the queries). With ``lang_enhanced`` the self-
attention stacks become ``FFWRelativeSelfCrossAttentionModule``s (3 cross
layers among the 4 self layers, 1 among each head's 2) that attend to the
instruction; as in the JAX module, their self layers then take no key mask,
and without an instruction they have no cross layers at all.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from portbench.reference.models.layers import (
    FFWRelativeCrossAttentionModule,
    FFWRelativeSelfAttentionModule,
    FFWRelativeSelfCrossAttentionModule,
    ParallelAttention,
)
from portbench.reference.ops.positional import rotary_pe_3d, sinusoidal_pos_emb


class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dropout(F.relu(self.fc1(x))))


class DiffusionHead(nn.Module):
    def __init__(
        self,
        embedding_dim: int = 120,
        num_attn_heads: int = 8,
        rotation_dim: int = 6,
        nhist: int = 3,
        ngrippers: int = 1,
        predict_head_yaw: bool = False,
        diffusion_dropout: float = 0.0,
        predictor_dropout: float = 0.0,
        use_instruction: bool = False,
        lang_enhanced: bool = False,
        prediction_horizon: int = 1,
    ):
        super().__init__()
        E = embedding_dim
        attn_drop, mlp_drop = diffusion_dropout, predictor_dropout
        self.embedding_dim = E
        self.use_instruction = use_instruction
        self.lang_enhanced = lang_enhanced
        self.traj_encoder = nn.Linear(9, E)
        self.time_emb_l1 = nn.Linear(E, E)
        self.time_emb_l2 = nn.Linear(E, E)
        self.gripper_hist_l1 = nn.Linear(nhist * ngrippers * E, E)
        self.gripper_hist_l2 = nn.Linear(E, E)
        if use_instruction:
            self.traj_lang_attention = ParallelAttention(
                1, E, num_attn_heads, dropout=attn_drop, self_attention1=False,
                cross_attention1=True, apply_ffn=False,
            )
        self.cross_attn = FFWRelativeCrossAttentionModule(
            E, num_attn_heads, num_layers=2, use_adaln=True, dropout=attn_drop
        )

        def self_stack(num_layers, num_cross):
            if lang_enhanced:
                return FFWRelativeSelfCrossAttentionModule(
                    E, num_attn_heads, num_layers, num_cross, use_adaln=True,
                    dropout=attn_drop, with_context=use_instruction)
            return FFWRelativeSelfAttentionModule(
                E, num_attn_heads, num_layers=num_layers, use_adaln=True, dropout=attn_drop)

        self.self_attn = self_stack(4, 3)
        self.rotation_proj = nn.Linear(E, E)
        self.rotation_self_attn = self_stack(2, 1)
        self.rotation_predictor = Mlp(E, E, rotation_dim, mlp_drop)
        self.position_proj = nn.Linear(E, E)
        self.position_self_attn = self_stack(2, 1)
        self.position_predictor = Mlp(E, E, 3, mlp_drop)
        self.openness_predictor = Mlp(E, E, 1, mlp_drop)
        self.head_yaw_predictor = (
            Mlp(ngrippers * E, E, 1, mlp_drop) if predict_head_yaw else None
        )

    def encode_denoising_timestep(
        self, timestep: torch.Tensor, gripper_history_features: torch.Tensor
    ) -> torch.Tensor:
        """(B,) timestep + (B, M, E) history features -> (B, E) AdaLN signal."""
        t = sinusoidal_pos_emb(timestep, self.embedding_dim)
        t = self.time_emb_l2(F.relu(self.time_emb_l1(t)))
        g = gripper_history_features.reshape(gripper_history_features.shape[0], -1)
        g = self.gripper_hist_l2(F.relu(self.gripper_hist_l1(g)))
        return t + g

    def forward(
        self,
        trajectory: torch.Tensor,
        timestep: torch.Tensor,
        context_feats: torch.Tensor,
        context: torch.Tensor,
        context_mask: torch.Tensor,
        adaln_gripper_feats: torch.Tensor,
        fps_feats: torch.Tensor,
        fps_pos: torch.Tensor,
        fps_mask: torch.Tensor,
        instr_feats: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Denoise one step.

        Args:
            trajectory: (B, L, G, 9) noisy normalized trajectory.
            timestep: (B,) diffusion step indices.
            context_feats/context/context_mask: full context tokens.
            adaln_gripper_feats: (B, nhist*G, E) gripper-history embedding.
            fps_feats/fps_pos/fps_mask: subsampled context tokens.
            instr_feats: (B, T, E) encoded instruction (language models).
            impl: attention impl (None = the process-wide default).

        Returns:
            (traj_pred (B, L, G, 10): pos+rot6d+openness logit,
             head_yaw (B, L, 1) or None,
             last cross-attn layer's weights averaged over heads (B, L*G, N),
             or None under the flash impl).
        """
        B, L, G, _ = trajectory.shape
        if trajectory.shape[-1] != 9:
            raise ValueError(f"expected (B, L, G, 9) trajectories, got {tuple(trajectory.shape)}")
        E = self.embedding_dim
        n_traj = L * G

        traj_feats = self.traj_encoder(trajectory).reshape(B, n_traj, E)
        traj_time_pos = sinusoidal_pos_emb(
            torch.arange(n_traj, dtype=torch.float32, device=trajectory.device), E
        )[None]
        if self.use_instruction and instr_feats is not None:
            traj_feats = self.traj_lang_attention(traj_feats, instr_feats,
                                                  seq1_sem_pos=traj_time_pos, impl=impl)
        traj_feats = traj_feats + traj_time_pos

        # Branchless empty-sample fallback: all-masked rows become all-active
        # with zeroed features so attention weights stay finite.
        empty = ~torch.any(context_mask, dim=-1)
        context_mask = context_mask | empty[:, None]
        context_feats = torch.where(empty[:, None, None], 0.0, context_feats)
        empty_fps = ~torch.any(fps_mask, dim=-1)
        fps_mask = fps_mask | empty_fps[:, None]
        fps_feats = torch.where(empty_fps[:, None, None], 0.0, fps_feats)

        time_embs = self.encode_denoising_timestep(timestep, adaln_gripper_feats)

        traj_xyz = trajectory[..., :3].reshape(B, n_traj, 3)
        rel_gripper_pos = rotary_pe_3d(traj_xyz, E)
        rel_context_pos = rotary_pe_3d(context, E)

        outputs, all_weights = self.cross_attn(
            traj_feats,
            context_feats,
            diff_ts=time_embs,
            query_pos=rel_gripper_pos,
            value_pos=rel_context_pos,
            key_padding_mask=~context_mask,
            impl=impl,
        )
        features = torch.cat([outputs[-1], fps_feats], dim=1)
        rel_pos = torch.cat([rel_gripper_pos, fps_pos], dim=1)
        combined_mask = torch.cat(
            [torch.zeros((B, n_traj), dtype=torch.bool, device=fps_mask.device),
             ~fps_mask],
            dim=1,
        )

        def self_stack(module, x):
            if self.lang_enhanced:  # no key mask, as in the JAX module
                return module(x, instr_feats, diff_ts=time_embs, query_pos=rel_pos,
                              impl=impl)[-1]
            return module(x, diff_ts=time_embs, query_pos=rel_pos,
                          key_padding_mask=combined_mask, impl=impl)[-1]

        features = self_stack(self.self_attn, features)
        rot_feats = self_stack(self.rotation_self_attn, features)[:, :n_traj]
        rotation = self.rotation_predictor(self.rotation_proj(rot_feats))

        pos_feats = self_stack(self.position_self_attn, features)[:, :n_traj]
        pos_feats = self.position_proj(pos_feats)
        position = self.position_predictor(pos_feats)
        openness = self.openness_predictor(pos_feats)

        head_yaw = None
        if self.head_yaw_predictor is not None:
            head_yaw = self.head_yaw_predictor(pos_feats.reshape(B, L, G * E))

        traj_pred = torch.cat([position, rotation, openness], dim=-1)
        traj_pred = traj_pred.reshape(B, L, G, 10)
        cross_attn_weights = (
            None if all_weights[-1] is None else all_weights[-1].mean(dim=1)
        )
        return traj_pred, head_yaw, cross_attn_weights
