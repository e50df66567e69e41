"""Pretrained-backbone loading: one call from a converted ``.npz`` to a module.

Port of the model side of ``nvblox_mindmap_tpu/models/pretrained.py``. The
checkpoint is the JAX package's converted format (``weight_conversion``):
the flax-layout ViT tree, optionally with the input normalization
(``norm_mean``/``norm_std``) beside it.

- ``require_backbone_weights``: fail fast when a non-RGB backbone would run
  with random weights.
- ``build_backbone``: the extractor module with the checkpoint's weights,
  normalization and CLS/register token count, on ``cuda`` unless the
  caller names a device.
- ``load_backbone_into_model``: the checkpoint into a ``DiffuserActor``'s
  ``encoder.feature_extractor``, strictly (the counterpart of the JAX
  package's ``graft_backbone_into_model_params``).
- ``make_feature_fn``: the mapping side's (H, W, 3) -> (h, w, F) feature
  image at the integration resolution; ``backbone_feature_fn`` wraps a
  backbone module already built.

A CLIP checkpoint holds the frozen trunk under ``backbone`` and, once a
policy has trained one (``scripts/extract_fpn_from_model``), the FPN under
``fpn``. Without ``fpn``, ``build_backbone`` initializes a fresh FPN and
warns, and ``load_backbone_into_model`` loads the trunk only, leaving the
model's FPN to train (upstream trains the FPN when no ``fpn_path`` is
given).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.models.feature_extractors import (
    FeatureExtractorType,
    make_feature_extractor,
    resize_bilinear,
)
from nvblox_mindmap_torch.models.layers import init_as_flax_
from nvblox_mindmap_torch.models.weight_conversion import load_variables_npz
from nvblox_mindmap_torch.models.weights import load_flax_params

logger = logging.getLogger(__name__)


def require_backbone_weights(
    feature_type: FeatureExtractorType,
    backbone_weights: Optional[str],
    context: str,
) -> None:
    """Fail fast when a non-RGB backbone would run with random weights."""
    feature_type = FeatureExtractorType(feature_type)
    if feature_type == FeatureExtractorType.RGB or backbone_weights:
        return
    raise ValueError(
        f"{context} runs the {feature_type.value!r} feature extractor, which "
        "needs pretrained weights: pass a converted .npz checkpoint "
        "(see docs/pages/pretrained_weights.md for the offline conversion). "
        "Running a randomly initialized frozen backbone would produce noise "
        "features. Use feature_type 'rgb' for a weight-free extractor."
    )


def load_backbone_npz(path: str) -> Dict:
    """Load a converted backbone .npz: {"params": ..., norm_mean/std?: ...}.

    Accepts both layouts the converters emit: a top-level ``params`` tree, or
    a bare params tree (wrapped on the fly).
    """
    loaded = load_variables_npz(path)
    if "params" not in loaded:
        loaded = {"params": loaded}
    return loaded


def _mean_std_from(loaded: Dict) -> Optional[Tuple]:
    if "norm_mean" in loaded and "norm_std" in loaded:
        return (
            tuple(float(x) for x in np.asarray(loaded["norm_mean"]).reshape(-1)),
            tuple(float(x) for x in np.asarray(loaded["norm_std"]).reshape(-1)),
        )
    return None


def _num_prefix_tokens_from(params: Dict) -> Optional[int]:
    if "prefix_tokens" in params:
        return int(np.asarray(params["prefix_tokens"]).shape[1])
    return 0 if "pos_embed" in params else None


def _clip_trunk(params: Dict) -> Dict:
    """The trunk's tree in a CLIP checkpoint's params (the converter may
    wrap it in one more ``params``)."""
    trunk = params.get("backbone", params)
    return trunk["params"] if "params" in trunk else trunk


def build_backbone(
    feature_type: FeatureExtractorType,
    backbone_weights: Optional[str] = None,
    feature_image_size: Tuple[int, int] = (32, 32),
    device: DeviceLike = None,
) -> nn.Module:
    """The extractor module for ``feature_type`` on ``device`` (default
    ``cuda``; raises when CUDA is absent and no device is given).

    A ViT takes its weights, input normalization and CLS/register token
    count from the converted checkpoint; the RGB extractor has no weights.
    CLIP takes its trunk, and its FPN where the checkpoint has one; else the
    FPN is freshly initialized (flax's initialisers, torch's generator) and
    a warning says so.
    """
    device = resolve_device(device)
    feature_type = FeatureExtractorType(feature_type)
    if feature_type == FeatureExtractorType.RGB:
        return make_feature_extractor(feature_type, feature_image_size).to(device)
    require_backbone_weights(feature_type, backbone_weights, "build_backbone")
    loaded = load_backbone_npz(backbone_weights)
    if feature_type == FeatureExtractorType.CLIP_RESNET50_FPN:
        module = init_as_flax_(make_feature_extractor(feature_type, feature_image_size))
        load_flax_params(module.backbone, _clip_trunk(loaded["params"]))
        if "fpn" in loaded["params"]:
            load_flax_params(module.fpn, loaded["params"]["fpn"])
        else:
            # For a mapping / datagen export a random neck means the 120-d
            # features written to disk are a random projection of the trunk.
            logger.warning(
                "CLIP checkpoint %r has no 'fpn' subtree: the FPN neck is freshly "
                "initialized, so extracted 120-d features are a random projection of "
                "the frozen trunk. This matches upstream's training semantics (the "
                "FPN trains when no fpn_path is given), but a mapping / datagen export "
                "likely wants a trained FPN: extract one with "
                "scripts/extract_fpn_from_model.", backbone_weights)
        return module.to(device)
    module = make_feature_extractor(
        feature_type,
        feature_image_size=feature_image_size,
        mean_std=_mean_std_from(loaded),
        num_prefix_tokens=_num_prefix_tokens_from(loaded["params"]),
    )
    load_flax_params(module, loaded["params"])
    return module.to(device)


def load_backbone_into_model(
    model: nn.Module,
    feature_type: FeatureExtractorType,
    backbone_weights: str,
) -> None:
    """Load converted weights into ``model.encoder.feature_extractor`` (in place).

    Loading is strict; a checkpoint whose CLS/register token count differs
    from the model's raises and names the config field to change. For CLIP
    only the trunk is replaced, and the FPN where the checkpoint has one.
    """
    loaded = load_backbone_npz(backbone_weights)
    pretrained = loaded["params"]
    extractor = model.encoder.feature_extractor
    if FeatureExtractorType(feature_type) == FeatureExtractorType.CLIP_RESNET50_FPN:
        load_flax_params(extractor.backbone, _clip_trunk(pretrained))
        if "fpn" in pretrained:
            load_flax_params(extractor.fpn, pretrained["fpn"])
        return
    ckpt_n = _num_prefix_tokens_from(pretrained) or 0
    model_n = getattr(extractor, "num_prefix_tokens", 0)
    if ckpt_n != model_n:
        raise ValueError(
            f"checkpoint has {ckpt_n} CLS/register prefix tokens but the "
            f"model was built with {model_n}; pass "
            f"feature_num_prefix_tokens={ckpt_n} so the architecture "
            "matches the converted weights"
        )
    load_flax_params(extractor, pretrained)


FeatureFn = Callable[[object], torch.Tensor]


def _rgb_on(rgb, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(rgb, device=device).to(torch.float32)


def backbone_feature_fn(backbone: nn.Module, output_size: Tuple[int, int]) -> FeatureFn:
    """(H, W, 3) RGB in [0, 1] -> (output_size, F) fp32 features on the
    backbone's device: the backbone's feature image, bilinearly upscaled to
    the integration resolution."""
    device = next(backbone.parameters()).device

    @torch.no_grad()
    def feature_fn(rgb) -> torch.Tensor:
        feats = backbone(_rgb_on(rgb, device)[None])
        return resize_bilinear(feats, output_size)[0]

    return feature_fn


def make_feature_fn(
    feature_type: FeatureExtractorType,
    output_size: Tuple[int, int],
    backbone_weights: Optional[str] = None,
    feature_image_size: Tuple[int, int] = (32, 32),
    device: DeviceLike = None,
) -> FeatureFn:
    """(H, W, 3) [0, 1] -> (output_size, F) feature extractor for mapping,
    on ``device`` (default ``cuda``; raises when CUDA is absent and no device
    is given).

    The mapper integrates features at ``output_size`` (upstream 512x512).
    RGB needs no weights: the image itself, resized. Every other type needs
    a converted checkpoint and runs its backbone at ``feature_image_size``
    (ViT patches, or CLIP's res3 grid), then upscales bilinearly.
    """
    device = resolve_device(device)
    feature_type = FeatureExtractorType(feature_type)
    if feature_type == FeatureExtractorType.RGB:

        @torch.no_grad()
        def rgb_fn(rgb) -> torch.Tensor:
            return resize_bilinear(_rgb_on(rgb, device)[None], output_size)[0]

        return rgb_fn

    require_backbone_weights(feature_type, backbone_weights, "feature mapping")
    backbone = build_backbone(feature_type, backbone_weights, feature_image_size, device)
    return backbone_feature_fn(backbone, output_size)
