"""Context encoder for the DiffuserActor policy (torch, batch-first).

Port of the non-language parts of ``nvblox_mindmap_tpu/models/encoder.py``:

- ``encode_images``: frozen backbone features -> linear embed -> bilinear
  position resample -> AND-pooled validity mask.
- ``encode_feature_pointcloud``: mesh vertex features (B, N, C) linearly
  embedded to the model width by ``reconstruction_encoder`` (or by the image
  encoder, with ``use_shared_feature_encoder``).
- ``encode_gripper_history``: openness-conditioned queries (or one learnt
  query per slot, without ``encode_openness``) cross-attending (3 rotary
  layers) to the full context.
- ``run_fps``: feature-space farthest point sampling with zeroed invalid
  tokens.

The backbone is frozen, as the JAX package's ``stop_gradient`` freezes it:
its parameters have ``requires_grad=False`` and its forward records no
graph; gradients reach everything after it (``image_feature_encoder``, the
features FPS gathers). ``backbone_chunk_images`` runs it over the
(B * ncam) images in chunks of that many, a memory lever for large train
batches. ``dropout`` goes to the gripper-history cross-attention layers.

Which encoders exist follows ``data_type``, so the parameter tree matches
the flax module's for every data type. The language layers are a later
slice; ``DiffuserActorConfig`` raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from nvblox_mindmap_torch.models.feature_extractors import (
    FeatureExtractorType,
    get_feature_dim,
    make_feature_extractor,
    resize_bilinear,
)
from nvblox_mindmap_torch.models.layers import FFWRelativeCrossAttentionModule
from nvblox_mindmap_torch.ops.fps import farthest_point_sampling, gather_points
from nvblox_mindmap_torch.ops.masks import downscale_mask
from nvblox_mindmap_torch.ops.positional import rotary_pe_3d


class Encoder(nn.Module):
    def __init__(
        self,
        embedding_dim: int = 120,
        nhist: int = 3,
        ngrippers: int = 1,
        num_attn_heads: int = 8,
        fps_subsampling_factor: int = 5,
        data_type: str = "rgbd",
        encode_openness: bool = True,
        feature_type: FeatureExtractorType = FeatureExtractorType.RGB,
        feature_image_size: Tuple[int, int] = (32, 32),
        feature_num_prefix_tokens: Optional[int] = None,
        use_shared_feature_encoder: bool = False,
        vertex_feature_dim: int = 768,
        dropout: float = 0.0,
        backbone_chunk_images: Optional[int] = None,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.backbone_chunk_images = backbone_chunk_images
        self.nhist = nhist
        self.ngrippers = ngrippers
        self.fps_subsampling_factor = fps_subsampling_factor
        self.encode_openness = encode_openness
        self.use_shared_feature_encoder = use_shared_feature_encoder
        if data_type in ("rgbd", "rgbd_and_mesh"):
            self.feature_extractor = make_feature_extractor(
                feature_type, feature_image_size, num_prefix_tokens=feature_num_prefix_tokens
            )
            self.feature_extractor.requires_grad_(False)
            self.image_feature_encoder = nn.Linear(get_feature_dim(feature_type), embedding_dim)
        if data_type in ("mesh", "rgbd_and_mesh") and not use_shared_feature_encoder:
            self.reconstruction_encoder = nn.Linear(vertex_feature_dim, embedding_dim)
        n_queries = nhist * ngrippers
        if encode_openness:
            # A linear map of the binary open/close vector: equivalent to two
            # learnable queries per slot (open / closed).
            self.curr_open_close_encoder = nn.Linear(n_queries, n_queries * embedding_dim)
        else:
            self.gripper_history_embed = nn.Parameter(torch.randn(n_queries, embedding_dim))
        self.gripper_context_head = FFWRelativeCrossAttentionModule(
            embedding_dim, num_attn_heads, num_layers=3, use_adaln=False, dropout=dropout
        )
        # Unused on the keypose path, but part of every checkpoint.
        self.goal_gripper_embed = nn.Parameter(torch.randn(1, embedding_dim))

    def relative_pe(self, xyz: torch.Tensor) -> torch.Tensor:
        """Rotary 3D code for (B, N, 3) positions -> (B, N, F, 2)."""
        return rotary_pe_3d(xyz, self.embedding_dim)

    def encode_images(
        self,
        rgb: torch.Tensor,
        positions: torch.Tensor,
        valid_mask: Optional[torch.Tensor] = None,
    ):
        """Image observations to context tokens.

        Args:
            rgb: (B, ncam, H, W, 3) in [0, 1].
            positions: (B, ncam, H, W, 3) world points.
            valid_mask: optional (B, ncam, H, W) bool.

        Returns:
            feats (B, ncam*h*w, E), positions (B, ncam*h*w, 3),
            mask (B, ncam*h*w) or None.
        """
        B, ncam, H, W, _ = rgb.shape
        flat_rgb = rgb.reshape(B * ncam, H, W, 3)
        chunk = self.backbone_chunk_images
        if chunk and B * ncam > chunk and (B * ncam) % chunk == 0:
            # One chunk's backbone activations live at a time. A chunk that
            # does not divide the images falls back to one call, as in the
            # JAX package.
            feats = torch.cat([self.feature_extractor(x) for x in flat_rgb.split(chunk)])
        else:
            feats = self.feature_extractor(flat_rgb)  # (B*ncam, h, w, C)
        h, w = feats.shape[1:3]
        feats = self.image_feature_encoder(feats)
        pos = resize_bilinear(positions.reshape(B * ncam, H, W, 3), (h, w))
        feats = feats.reshape(B, ncam * h * w, self.embedding_dim)
        pos = pos.reshape(B, ncam * h * w, 3)
        mask = None
        if valid_mask is not None:
            if h != w or H % h:
                raise ValueError(f"cannot pool a {H}x{W} mask onto the {h}x{w} feature grid")
            mask = downscale_mask(valid_mask, H // h).reshape(B, ncam * h * w)
        return feats, pos, mask

    def encode_feature_pointcloud(self, features: torch.Tensor, points: torch.Tensor):
        """Mesh vertex features (B, N, C) + vertices (B, N, 3) -> embedded tokens."""
        encoder = (self.image_feature_encoder if self.use_shared_feature_encoder
                   else self.reconstruction_encoder)
        return encoder(features.to(torch.float32)), points

    def encode_gripper_history(
        self,
        gripper_history: torch.Tensor,
        context_feats: torch.Tensor,
        context: torch.Tensor,
        curr_closedness: torch.Tensor,
        impl: Optional[str] = None,
    ):
        """Gripper-history queries cross-attend to the scene context.

        Args:
            gripper_history: (B, nhist, ngrippers, >=3) poses.
            context_feats: (B, N, E); context: (B, N, 3).
            curr_closedness: (B, nhist, ngrippers, 1).
            impl: attention impl (None = the process-wide default).

        Returns:
            (feats (B, nhist*ngrippers, E), pos code, last-layer weights).
        """
        B = gripper_history.shape[0]
        n_queries = self.nhist * self.ngrippers
        if self.encode_openness:
            queries = self.curr_open_close_encoder(
                curr_closedness.reshape(B, n_queries)
            ).reshape(B, n_queries, self.embedding_dim)
        else:
            queries = self.gripper_history_embed[None].expand(B, n_queries, self.embedding_dim)
        gripper_pos = self.relative_pe(gripper_history[..., :3].reshape(B, n_queries, 3))
        context_pos = self.relative_pe(context)
        outputs, weights = self.gripper_context_head(
            queries, context_feats, query_pos=gripper_pos, value_pos=context_pos, impl=impl
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
