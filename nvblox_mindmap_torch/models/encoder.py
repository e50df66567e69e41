"""Context encoder for the DiffuserActor policy (torch, batch-first).

Port of the mesh branch of ``nvblox_mindmap_tpu/models/encoder.py``:

- ``encode_feature_pointcloud``: mesh vertex features (B, N, C) linearly
  embedded to the model width by ``reconstruction_encoder``.
- ``encode_gripper_history``: openness-conditioned queries cross-attending
  (3 rotary layers) to the full context.
- ``run_fps``: feature-space farthest point sampling with zeroed invalid
  tokens.

The image branch (``encode_images``) and the language layers are later
slices; ``DiffuserActorConfig`` raises ``NotImplementedError`` naming them.
"""
from __future__ import annotations

import torch
from torch import nn

from nvblox_mindmap_torch.models.layers import FFWRelativeCrossAttentionModule
from nvblox_mindmap_torch.ops.fps import farthest_point_sampling, gather_points
from nvblox_mindmap_torch.ops.positional import rotary_pe_3d

class Encoder(nn.Module):
    def __init__(
        self,
        embedding_dim: int = 120,
        nhist: int = 3,
        ngrippers: int = 1,
        num_attn_heads: int = 8,
        fps_subsampling_factor: int = 5,
        vertex_feature_dim: int = 768,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.nhist = nhist
        self.ngrippers = ngrippers
        self.fps_subsampling_factor = fps_subsampling_factor
        n_queries = nhist * ngrippers
        self.reconstruction_encoder = nn.Linear(vertex_feature_dim, embedding_dim)
        # A linear map of the binary open/close vector: equivalent to two
        # learnable queries per slot (open / closed).
        self.curr_open_close_encoder = nn.Linear(n_queries, n_queries * embedding_dim)
        self.gripper_context_head = FFWRelativeCrossAttentionModule(
            embedding_dim, num_attn_heads, num_layers=3, use_adaln=False
        )
        # Unused on the keypose path, but part of every checkpoint.
        self.goal_gripper_embed = nn.Parameter(torch.randn(1, embedding_dim))

    def relative_pe(self, xyz: torch.Tensor) -> torch.Tensor:
        """Rotary 3D code for (B, N, 3) positions -> (B, N, F, 2)."""
        return rotary_pe_3d(xyz, self.embedding_dim)

    def encode_feature_pointcloud(self, features: torch.Tensor, points: torch.Tensor):
        """Mesh vertex features (B, N, C) + vertices (B, N, 3) -> embedded tokens."""
        return self.reconstruction_encoder(features.to(torch.float32)), points

    def encode_gripper_history(
        self,
        gripper_history: torch.Tensor,
        context_feats: torch.Tensor,
        context: torch.Tensor,
        curr_closedness: torch.Tensor,
    ):
        """Gripper-history queries cross-attend to the scene context.

        Args:
            gripper_history: (B, nhist, ngrippers, >=3) poses.
            context_feats: (B, N, E); context: (B, N, 3).
            curr_closedness: (B, nhist, ngrippers, 1).

        Returns:
            (feats (B, nhist*ngrippers, E), pos code, last-layer weights).
        """
        B = gripper_history.shape[0]
        n_queries = self.nhist * self.ngrippers
        queries = self.curr_open_close_encoder(
            curr_closedness.reshape(B, n_queries)
        ).reshape(B, n_queries, self.embedding_dim)
        gripper_pos = self.relative_pe(gripper_history[..., :3].reshape(B, n_queries, 3))
        context_pos = self.relative_pe(context)
        outputs, weights = self.gripper_context_head(
            queries, context_feats, query_pos=gripper_pos, value_pos=context_pos
        )
        return outputs[-1], gripper_pos, weights[-1]

    def run_fps(
        self,
        context_features: torch.Tensor,
        context_pos: torch.Tensor,
        context_valid_mask: torch.Tensor,
    ):
        """Feature-space FPS subsampling with zeroed-invalid semantics.

        Invalid tokens are zeroed (not removed, so shapes stay fixed); the
        returned mask marks samples that landed on non-zero features.
        """
        B, N, C = context_features.shape
        masked = torch.where(context_valid_mask[..., None], context_features, 0.0)
        k = max(N // self.fps_subsampling_factor, 1)
        idx = farthest_point_sampling(masked, k, start_idx=0)
        sampled_feats = gather_points(masked, idx)
        sampled_pos = gather_points(context_pos, idx)
        sampled_valid = torch.any(sampled_feats != 0, dim=-1)
        return sampled_feats, sampled_pos, sampled_valid
