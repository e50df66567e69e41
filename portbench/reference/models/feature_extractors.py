"""Vision feature extractors (torch ``nn.Module``s), channel-last.

Port of ``nvblox_mindmap_tpu/models/feature_extractors.py``:

- ``RGB``: passthrough, bilinear resize to the feature size (3-d).
- ``RADIO_V25_B``: ViT-B/16-style backbone, 768-d patch features.
- ``DINO_V2_VITS14``: ViT-S/14, 384-d patch features.
- ``CLIP_RESNET50_FPN``: CLIP's ResNet-50 trunk (frozen) with a trainable
  FPN, 120-d res3 features (``models/clip_resnet_fpn.py``).

Every extractor takes channel-last RGB in [0, 1] of shape (B, H, W, 3) and
returns a (B, h, w, C) fp32 feature image.

The ViT mirrors the numerics of the flax module, which runs with
``dtype=bfloat16`` on fp32 parameters: each parameter is cast to bf16 where
it is used; the patch conv, the q/k/v/out projections, the attention
logits, softmax and weighted sum, the MLP and the residual stream are bf16;
the LayerNorms compute in fp32 (eps 1e-6) and cast back. Its attention is
the flax library's (``dot_product_attention``), written out here as eager
bf16 ops, not a kernel of this package. The backbone is frozen: its forward
runs under ``torch.no_grad``. Under the control's arithmetic
(``reference/precision.py``) the operands of its matrix products are
rounded to float8.

``resize_bilinear`` matches ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples: ``F.interpolate`` needs ``antialias=True``.
"""
from __future__ import annotations

import enum
import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from portbench.reference.models.layers import layer_norm
from portbench.reference.precision import fp8


class FeatureExtractorType(str, enum.Enum):
    CLIP_RESNET50_FPN = "clip_resnet50_fpn"
    RADIO_V25_B = "radio_v25_b"
    DINO_V2_VITS14 = "dino_v2_vits14"
    RGB = "rgb"


FEATURE_DIMS = {
    FeatureExtractorType.CLIP_RESNET50_FPN: 120,
    FeatureExtractorType.RADIO_V25_B: 768,
    FeatureExtractorType.DINO_V2_VITS14: 384,
    FeatureExtractorType.RGB: 3,
}

# Per-extractor input normalization (mean, std); RGB/RADIO use identity.
_IMAGENET = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
_WIT = ([0.48145466, 0.4578275, 0.40821073], [0.26862954, 0.26130258, 0.27577711])
_IDENTITY = ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0])

NORMALIZATION = {
    FeatureExtractorType.CLIP_RESNET50_FPN: _WIT,
    FeatureExtractorType.RADIO_V25_B: _IDENTITY,
    FeatureExtractorType.DINO_V2_VITS14: _IMAGENET,
    FeatureExtractorType.RGB: _IDENTITY,
}

# CLS/register token counts of the pretrained hub checkpoints; a converted
# checkpoint with another count overrides it through its 'prefix_tokens'.
DEFAULT_PREFIX_TOKENS = {
    FeatureExtractorType.RADIO_V25_B: 1,
    FeatureExtractorType.DINO_V2_VITS14: 1,
}

def get_feature_dim(t: FeatureExtractorType) -> int:
    return FEATURE_DIMS[FeatureExtractorType(t)]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Channel-last (B, H, W, C) bilinear resize with half-pixel centers,
    antialiased when downsampling, as ``jax.image.resize(..., "bilinear")``."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def _linear_bf16(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Dense(dtype=bfloat16)``: fp32 parameters cast at use (its
    operands in float8 under the control's arithmetic)."""
    return F.linear(fp8(x), fp8(layer.weight.to(torch.bfloat16)),
                    layer.bias.to(torch.bfloat16))


class RgbFeatureExtractor(nn.Module):
    """Passthrough extractor: scaled RGB is the feature."""

    def __init__(self, feature_image_size: Tuple[int, int] = (32, 32)):
        super().__init__()
        self.feature_image_size = tuple(feature_image_size)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(rgb, self.feature_image_size)


class VitAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(dtype=bfloat16)`` self-attention.

    ``query``/``key``/``value`` are flax ``DenseGeneral`` E -> (H, D) and
    ``out`` (H, D) -> E; here each is an ``nn.Linear`` over H*D features.
    """

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, E = x.shape
        H = self.num_heads
        D = E // H
        q = _linear_bf16(self.query, x).reshape(B, N, H, D)
        k = _linear_bf16(self.key, x).reshape(B, N, H, D)
        v = _linear_bf16(self.value, x).reshape(B, N, H, D)
        q = q / math.sqrt(D)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", fp8(q), fp8(k)), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", fp8(weights), fp8(v))
        return _linear_bf16(self.out, out.reshape(B, N, E))


class VitFeatureExtractor(nn.Module):
    """Patch-token ViT backbone returning a (B, h, w, C) feature image.

    Covers RADIO v2.5-b (patch 16, 768-d, 12 layers, 12 heads) and DINOv2
    ViT-S/14 (patch 14, 384-d, 12 layers, 6 heads, LayerScale). Prefix
    (CLS/register) tokens arrive with their positions folded in by the
    converter, attend with the patches and are dropped from the output.
    """

    def __init__(
        self,
        patch_size: int,
        width: int,
        depth: int,
        num_heads: int,
        feature_image_size: Tuple[int, int] = (32, 32),
        mean_std: Tuple = _IDENTITY,
        mlp_ratio: float = 4.0,
        num_prefix_tokens: int = 0,
        use_layer_scale: bool = False,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.width = width
        self.feature_image_size = tuple(feature_image_size)
        self.num_prefix_tokens = num_prefix_tokens
        self.register_buffer("mean", torch.tensor(mean_std[0], dtype=torch.float32),
                             persistent=False)
        self.register_buffer("std", torch.tensor(mean_std[1], dtype=torch.float32),
                             persistent=False)
        h, w = self.feature_image_size
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.randn(1, h * w, width) * 0.02)
        self.prefix_tokens = (
            nn.Parameter(torch.randn(1, num_prefix_tokens, width) * 0.02)
            if num_prefix_tokens > 0 else None
        )
        hidden = int(width * mlp_ratio)
        self.ln1 = nn.ModuleList(layer_norm(width) for _ in range(depth))
        self.attn = nn.ModuleList(VitAttention(width, num_heads) for _ in range(depth))
        self.ln2 = nn.ModuleList(layer_norm(width) for _ in range(depth))
        self.mlp1 = nn.ModuleList(nn.Linear(width, hidden) for _ in range(depth))
        self.mlp2 = nn.ModuleList(nn.Linear(hidden, width) for _ in range(depth))
        # LayerScale gammas (DINOv2), one per residual branch and block.
        def gammas():
            return (nn.ParameterList(nn.Parameter(torch.ones(width)) for _ in range(depth))
                    if use_layer_scale else None)

        self.ls1 = gammas()
        self.ls2 = gammas()
        self.ln_final = layer_norm(width)

    @torch.no_grad()
    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        bf16 = torch.bfloat16
        x = (rgb - self.mean) / self.std
        # Size the input so the patch grid equals the requested feature size.
        in_size = tuple(s * self.patch_size for s in self.feature_image_size)
        x = resize_bilinear(x, in_size).to(bf16)
        x = F.conv2d(fp8(x.permute(0, 3, 1, 2)), fp8(self.patch_embed.weight.to(bf16)),
                     self.patch_embed.bias.to(bf16), stride=self.patch_size)
        B, C, h, w = x.shape
        x = x.flatten(2).transpose(1, 2) + self.pos_embed.to(bf16)
        if self.prefix_tokens is not None:
            prefix = self.prefix_tokens.to(bf16).expand(B, -1, -1)
            x = torch.cat([prefix, x], dim=1)

        def scaled(y, gammas, i):
            return y if gammas is None else y * gammas[i].to(bf16)

        for i, attn in enumerate(self.attn):
            y = self.ln1[i](x.float()).to(bf16)
            x = x + scaled(attn(y), self.ls1, i)
            y = self.ln2[i](x.float()).to(bf16)
            # Exact (erf) GELU, as the torch checkpoints were trained.
            y = _linear_bf16(self.mlp2[i], F.gelu(_linear_bf16(self.mlp1[i], y)))
            x = x + scaled(y, self.ls2, i)

        x = self.ln_final(x.float())[:, self.num_prefix_tokens:]
        return x.reshape(B, h, w, C)


def make_feature_extractor(
    t: FeatureExtractorType,
    feature_image_size: Tuple[int, int] = (32, 32),
    mean_std: Optional[Tuple] = None,
    num_prefix_tokens: Optional[int] = None,
) -> nn.Module:
    """The extractor module for a registry type.

    ``mean_std`` overrides the registry input normalization (converted
    checkpoints may carry their own); ``num_prefix_tokens`` overrides the
    hub default CLS/register token count.
    """
    t = FeatureExtractorType(t)
    if t == FeatureExtractorType.RGB:
        return RgbFeatureExtractor(feature_image_size=feature_image_size)
    if t == FeatureExtractorType.CLIP_RESNET50_FPN:
        # CLIP's own normalization, whatever the checkpoint carries.
        from portbench.reference.models.clip_resnet_fpn import ClipResNet50Fpn

        return ClipResNet50Fpn(feature_image_size=feature_image_size)
    if num_prefix_tokens is None:
        num_prefix_tokens = DEFAULT_PREFIX_TOKENS.get(t, 0)
    if t == FeatureExtractorType.RADIO_V25_B:
        return VitFeatureExtractor(
            patch_size=16, width=768, depth=12, num_heads=12,
            feature_image_size=feature_image_size,
            mean_std=mean_std or NORMALIZATION[t],
            num_prefix_tokens=num_prefix_tokens,
        )
    return VitFeatureExtractor(
        patch_size=14, width=384, depth=12, num_heads=6,
        feature_image_size=feature_image_size,
        mean_std=mean_std or NORMALIZATION[t],
        num_prefix_tokens=num_prefix_tokens,
        use_layer_scale=True,  # DINOv2 hub blocks carry ls1/ls2 gammas
    )
