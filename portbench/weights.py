"""Seeded random weights, made on the device in one draw.

Both sides of a cell get the same state dict from ``random_state_dict``: the
program's model loads it, and so does the plain reference. The rule reads
only the names and shapes of the parameters:

- biases: 0.02 N(0, 1);
- one-dimensional scales (LayerNorm and BatchNorm ``weight``): 1 + 0.1 N(0, 1);
- BatchNorm statistics (``mean`` / ``var``): set by ``calibrate_batchnorm``
  from random images through the reference's copy of the trunk in IEEE
  float32, so that each BatchNorm's output is normalized, as in the smoke
  script's CLIP weights;
- everything else: N(0, 1) / sqrt(fan-in), fan-in being the product of all
  but the first dimension (0.02 N(0, 1) for position embeddings and prefix
  tokens).
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _scale(name: str, shape) -> tuple:
    """(mean, std) of the entries of parameter ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return 0.0, 0.02
    if leaf in ("mean", "var"):
        return (1.0 if leaf == "var" else 0.0), 0.0
    if len(shape) == 1:
        return 1.0, 0.1
    if leaf in ("pos_embed", "prefix_tokens"):
        return 0.0, 0.02
    return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def random_state_dict(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 tensors of the given shapes, by name, from one normal draw of
    a generator on ``device`` seeded with ``seed``."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name in names:
        shape = tuple(shapes[name])
        count = math.prod(shape)
        mean, std = _scale(name, shape)
        out[name] = flat[offset:offset + count].view(shape).mul_(std).add_(mean)
        offset += count
    return out


@torch.no_grad()
def calibrate_batchnorm(state: Dict[str, torch.Tensor], prefix: str, image: int, seed: int,
                        device) -> None:
    """Set the BatchNorm statistics under ``prefix`` (a CLIP ResNet-50
    trunk's) in ``state`` to the per-channel mean and variance of their
    inputs over 8 random CLIP-normalized images, in the trunk's order."""
    from portbench.reference.models.clip_resnet_fpn import (
        CLIP_MEAN,
        CLIP_STD,
        FrozenBatchNorm,
        ModifiedResNetFeatures,
    )

    with torch.device(device):
        trunk = ModifiedResNetFeatures()
    trunk.load_state_dict({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})

    def calibrate(bn, args):
        x = args[0]
        bn.mean.copy_(x.mean((0, 2, 3)))
        bn.var.copy_(x.var((0, 2, 3)))

    hooks = [m.register_forward_pre_hook(calibrate) for m in trunk.modules()
             if isinstance(m, FrozenBatchNorm)]
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.rand(8, 3, image, image, generator=gen, device=device)
    mean, std = (torch.tensor(v, device=device)[:, None, None] for v in (CLIP_MEAN, CLIP_STD))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # IEEE, whichever side calls
    try:
        trunk((images - mean) / std)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        for hook in hooks:
            hook.remove()
    for name, p in trunk.named_parameters():
        if name.rsplit(".", 1)[-1] in ("mean", "var"):
            state[prefix + name].copy_(p)
