"""Context encoder for the DiffuserActor policy (torch, batch-first).

Port of ``nvblox_mindmap_tpu/models/encoder.py``:

- ``encode_images``: frozen backbone features -> linear embed -> bilinear
  position resample -> AND-pooled validity mask.
- ``encode_feature_pointcloud``: mesh vertex features (B, N, C) linearly
  embedded to the model width by ``reconstruction_encoder`` (or by the image
  encoder, with ``use_shared_feature_encoder``).
- ``encode_gripper_history``: openness-conditioned queries (or one learnt
  query per slot, without ``encode_openness``) cross-attending (3 rotary
  layers) to the full context.
- ``encode_goal_gripper``: the learnt goal query (``goal_gripper_embed``)
  at the goal's position through the same layers; no keypose path calls it.
- ``run_fps``: feature-space farthest point sampling with zeroed invalid
  tokens.
- ``encode_instruction`` (``instruction_encoder``: (B, T, 512) CLIP text
  features -> E, with a zero rotary code) and
  ``vision_language_attention`` (``vl_attention``: the context tokens
  cross-attend to the instruction, ``num_vis_ins_attn_layers`` layers);
  both exist only with ``use_instruction``, as flax creates them only when
  an instruction is encoded.

The backbone is frozen, as the JAX package's ``stop_gradient`` freezes it:
its parameters have ``requires_grad=False`` and its forward records no
graph; gradients reach everything after it (``image_feature_encoder``, the
features FPS gathers). CLIP's FPN sits after its frozen trunk and trains. ``backbone_chunk_images`` runs it over the
(B * ncam) images in chunks of that many, a memory lever for large train
batches. ``dropout`` goes to the gripper-history cross-attention layers.

Which encoders exist follows ``data_type``, so the parameter tree matches
the flax module's for every data type."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from portbench.reference.models.feature_extractors import (
    FeatureExtractorType,
    get_feature_dim,
    make_feature_extractor,
    resize_bilinear,
)
from portbench.reference.models.layers import (
    FFWRelativeCrossAttentionModule,
    ParallelAttention,
)
from portbench.reference.ops.fps import farthest_point_sampling, gather_points
from portbench.reference.ops.masks import downscale_mask
from portbench.reference.ops.positional import rotary_pe_3d

INSTRUCTION_DIM = 512  # CLIP text features, upstream's instruction encoding


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
        use_instruction: bool = False,
        num_vis_ins_attn_layers: int = 2,
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
            if feature_type == FeatureExtractorType.CLIP_RESNET50_FPN:
                self.feature_extractor.fpn.requires_grad_(True)
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
        if use_instruction:
            self.instruction_encoder = nn.Linear(INSTRUCTION_DIM, embedding_dim)
            self.vl_attention = ParallelAttention(
                num_vis_ins_attn_layers, embedding_dim, num_attn_heads, dropout=dropout,
                self_attention1=False, cross_attention1=True,
            )

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

    def encode_goal_gripper(
        self,
        goal_gripper: torch.Tensor,
        context_feats: torch.Tensor,
        context: torch.Tensor,
        impl: Optional[str] = None,
    ):
        """The goal-gripper query cross-attends to the context through the
        gripper-history layers.

        Args:
            goal_gripper: (B, >=3) goal pose (its xyz gives the rotary code).
            context_feats: (B, N, E); context: (B, N, 3).
            impl: attention impl (None = the process-wide default).

        Returns:
            (feats (B, 1, E), pos code (B, 1, E, 2)).
        """
        B = goal_gripper.shape[0]
        queries = self.goal_gripper_embed[None].expand(B, 1, self.embedding_dim)
        goal_pos = self.relative_pe(goal_gripper[:, None, :3])
        context_pos = self.relative_pe(context)
        outputs, _ = self.gripper_context_head(
            queries, context_feats, query_pos=goal_pos, value_pos=context_pos, impl=impl
        )
        return outputs[-1], goal_pos

    def encode_instruction(self, instruction: torch.Tensor):
        """(B, T, 512) CLIP text features -> (B, T, E) + a zero rotary code."""
        instr_feats = self.instruction_encoder(instruction.to(torch.float32))
        dummy_pos = self.relative_pe(torch.zeros(instruction.shape[:2] + (3,),
                                                 device=instruction.device))
        return instr_feats, dummy_pos

    def vision_language_attention(self, feats: torch.Tensor, instr_feats: torch.Tensor,
                                  impl: Optional[str] = None) -> torch.Tensor:
        """The context tokens (B, N, E) cross-attend to the instruction."""
        return self.vl_attention(feats, instr_feats, impl=impl)

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
