"""CLIP ModifiedResNet-50 backbone + Feature Pyramid Network (torch).

Port of ``nvblox_mindmap_tpu/models/clip_resnet_fpn.py``, upstream's
CLIP_RESNET50_FPN extractor:

- ``FrozenBatchNorm``: batch statistics kept as (frozen) parameters, so a
  checkpoint holds the whole extractor: ``x * inv + (bias - mean * inv)``
  with ``inv = scale * rsqrt(var + 1e-5)``.
- ``Bottleneck``: CLIP's anti-aliased bottleneck (expansion 4): a strided
  block average-pools before ``conv3`` and on the identity path.
- ``ModifiedResNetFeatures``: the 3-conv stem and the 4 stages, emitting 5
  feature maps [stem, layer1..layer4].
- ``FeaturePyramidNetwork``: torchvision's FPN: 1x1 laterals, a top-down
  nearest upsample, 3x3 outputs, 120 channels.
- ``ClipResNet50Fpn``: CLIP's input normalization (hard-coded; a
  checkpoint's ``mean_std`` is ignored, as in the JAX package), a bilinear
  resize to 8x ``feature_image_size``, the trunk, the FPN, and the res3
  level (stride 8), so a 256x256 input gives 32x32 features.

The trunk is frozen: its parameters do not require grad and its forward
records no graph (the JAX module's ``stop_gradient`` at the trunk/FPN
boundary). The FPN trains. The JAX function returns res3 only, so XLA
computes only what res3 reads; here ``ClipResNet50Fpn`` asks the FPN for
that level alone (laterals 2-4 and ``layer_2``), while every level keeps its
parameters (the weight bridge is strict and AdamW decays the unread ones).

Layout: the extractor takes and returns channel-last (B, H, W, C) tensors;
inside, the convolutions run channel-first. Precision: every convolution of
the extractor, forward and backward, is IEEE fp32 (TF32 off for its cuDNN
calls, whatever the process-wide flag says), as the JAX package's fp32
module computes on the CPU; TF32 under the control's arithmetic
(``reference/precision.py``). The nearest upsample uses half-pixel centres
(``nearest-exact``), as ``jax.image.resize(..., "nearest")`` does; torch's
``nearest`` differs from it except at exact integer scales.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from portbench.reference import precision
from portbench.reference.models.feature_extractors import resize_bilinear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in IEEE fp32 (no TF32) inside the block; in TF32
    under the control's arithmetic."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = precision.LOWERED
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Conv2dFp32(torch.autograd.Function):
    """``F.conv2d`` (stride 1) whose forward and backward both run in IEEE
    fp32: autograd's own backward would run at the flag's value at backward
    time."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        with fp32_convolutions():
            return F.conv2d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        grad_x = grad_w = grad_b = None
        with fp32_convolutions():
            if ctx.needs_input_grad[0]:
                grad_x = torch.nn.grad.conv2d_input(x.shape, weight, grad, padding=ctx.padding)
            if ctx.needs_input_grad[1]:
                grad_w = torch.nn.grad.conv2d_weight(x, weight.shape, grad, padding=ctx.padding)
        if ctx.needs_input_grad[2]:
            grad_b = grad.sum((0, 2, 3))
        return grad_x, grad_w, grad_b, None


def conv2d_fp32(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A stride-1 ``nn.Conv2d`` with a bias, through ``_Conv2dFp32``."""
    return _Conv2dFp32.apply(x, conv.weight, conv.bias, conv.padding)


def _conv(c_in: int, c_out: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2, bias=bias)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with its running statistics kept as (frozen) parameters;
    channel-first input. ``weight`` is flax's ``scale``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.var + self.eps)
        return x * inv[:, None, None] + (self.bias - self.mean * inv)[:, None, None]


class Bottleneck(nn.Module):
    """CLIP anti-aliased bottleneck (expansion 4)."""

    def __init__(self, c_in: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(c_in, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.has_downsample = stride > 1 or c_in != planes * 4
        if self.has_downsample:
            self.downsample_conv = _conv(c_in, planes * 4, 1)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class ModifiedResNetFeatures(nn.Module):
    """CLIP ModifiedResNet-50 emitting the 5 intermediate feature maps
    (channel-first): [res1 (width), res2 .. res5 (4, 8, 16, 32 x width)]."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = _conv(3, width // 2, 3, stride=2)
        self.bn1 = FrozenBatchNorm(width // 2)
        self.conv2 = _conv(width // 2, width // 2, 3)
        self.bn2 = FrozenBatchNorm(width // 2)
        self.conv3 = _conv(width // 2, width, 3)
        self.bn3 = FrozenBatchNorm(width)
        self.stages: List[List[str]] = []
        c_in, planes = width, width
        for stage, blocks in enumerate(layers):
            names = []
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(c_in, planes, stride))
                names.append(name)
                c_in = planes * 4
            self.stages.append(names)
            planes *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x0 = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x0, 2)
        feats = [x0]
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats

    def out_channels(self) -> List[int]:
        return [self.bn3.weight.numel()] + [
            getattr(self, names[-1]).bn3.weight.numel() for names in self.stages]


class FeaturePyramidNetwork(nn.Module):
    """torchvision-style FPN: lateral 1x1 + top-down nearest upsample + 3x3
    out, over channel-first maps."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 120):
        super().__init__()
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"inner_{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"layer_{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return conv2d_fp32(getattr(self, name), x)

    def _top_down(self, feats: Sequence[torch.Tensor], level: int) -> List[torch.Tensor]:
        """The merged maps ``last_i`` for i = n-1 down to ``level``."""
        last = self._conv(f"inner_{self.levels - 1}", feats[-1])
        merged = [last]
        for i in range(self.levels - 2, level - 1, -1):
            lateral = self._conv(f"inner_{i}", feats[i])
            last = lateral + F.interpolate(last, size=lateral.shape[-2:], mode="nearest-exact")
            merged.append(last)
        return merged[::-1]  # merged[j] is level + j

    def level(self, feats: Sequence[torch.Tensor], i: int) -> torch.Tensor:
        """Output level ``i`` alone: only the laterals and the output
        convolution that it reads."""
        return self._conv(f"layer_{i}", self._top_down(feats, i)[0])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every output level, finest first."""
        return [self._conv(f"layer_{i}", last)
                for i, last in enumerate(self._top_down(feats, 0))]


class ClipResNet50Fpn(nn.Module):
    """The full extractor: frozen trunk taps -> FPN -> the res3 (stride-8)
    feature image, channel-last."""

    RES3 = 2

    def __init__(self, feature_image_size: Tuple[int, int] = (32, 32), out_channels: int = 120):
        super().__init__()
        self.feature_image_size = tuple(feature_image_size)
        self.register_buffer("mean", torch.tensor(CLIP_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(CLIP_STD), persistent=False)
        self.backbone = ModifiedResNetFeatures()
        self.backbone.requires_grad_(False)
        self.fpn = FeaturePyramidNetwork(self.backbone.out_channels(), out_channels)

    def trunk(self, rgb: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) RGB in [0, 1] -> the trunk's 5 channel-first maps,
        without a graph."""
        x = (rgb - self.mean) / self.std
        # res3 is stride 8: the input is 8x the feature size.
        in_size = tuple(8 * s for s in self.feature_image_size)
        x = resize_bilinear(x, in_size).permute(0, 3, 1, 2)
        with torch.no_grad(), fp32_convolutions():
            return self.backbone(x)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        res3 = self.fpn.level(self.trunk(rgb), self.RES3)
        return res3.permute(0, 2, 3, 1)
