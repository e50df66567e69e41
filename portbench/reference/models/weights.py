"""Weight bridge: the JAX package's flax parameter tree -> the port's state_dict.

The input is the nested dict of numpy arrays that
``flax.serialization.msgpack_restore`` gives for a checkpoint's ``params``
(this module reads no msgpack itself). The mapping:

- a flax ``Dense`` ``kernel`` (in, out) becomes the ``nn.Linear`` ``weight``
  (out, in), transposed;
- a LayerNorm ``scale`` becomes ``weight``;
- flax's auto-names map to the port's attributes: ``MultiheadAttention_0``
  -> ``attention``, ``LayerNorm_0`` -> ``norm``, ``AdaLN_0`` -> ``adaln``,
  ``Dense_0`` / ``Dense_1`` (inside ``Mlp``) -> ``fc1`` / ``fc2``, and the
  stacked layers ``attn_{i}`` / ``ffw_{i}`` -> ``attn.{i}`` / ``ffw.{i}``
  (the ViT's ``ln1_{i}``, ``ln2_{i}``, ``mlp1_{i}``, ``mlp2_{i}``,
  ``ls1_{i}``, ``ls2_{i}`` likewise);
- the ViT under ``encoder/feature_extractor``: the ``patch_embed`` Conv
  kernel (kh, kw, in, out) becomes (out, in, kh, kw); the attention's
  ``DenseGeneral`` kernels ``query`` / ``key`` / ``value`` (E, H, D) become
  (H*D, E) and ``out`` (H, D, E) becomes (E, H*D); their (H, D) biases are
  flattened; ``pos_embed``, ``prefix_tokens`` and the LayerScale gammas are
  taken as they are.

- CLIP's ``FrozenBatchNorm`` leaves ``scale`` / ``bias`` / ``mean`` /
  ``var`` become its ``weight`` / ``bias`` / ``mean`` / ``var``; its
  ``Conv`` kernels are (kh, kw, in, out) like the ViT's.

Loading is strict: a key left over on either side, or a shape that differs,
raises. ``flax_paths`` runs the naming the other way: each of a model's
parameters to its path in the flax tree (the optimizer's weight-decay mask
is a rule on flax names). ``state_dict_to_flax`` runs the whole bridge the
other way, from the names and shapes of a state_dict alone (a port
checkpoint's parameters as the JAX package's tree).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from portbench.reference.models.clip_resnet_fpn import FrozenBatchNorm

AUTO_NAMES = {
    "MultiheadAttention_0": "attention",
    "LayerNorm_0": "norm",
    "AdaLN_0": "adaln",
    "Dense_0": "fc1",
    "Dense_1": "fc2",
}
_STACKED = re.compile(r"^(attn|ffw|ln1|ln2|mlp1|mlp2|ls1|ls2)_(\d+)$")


_FLAX_AUTO_NAMES = {torch_name: flax_name for flax_name, torch_name in AUTO_NAMES.items()}


def _rename(name: str) -> str:
    stacked = _STACKED.match(name)
    return f"{stacked[1]}.{stacked[2]}" if stacked else AUTO_NAMES.get(name, name)


def _convert_leaf(name: str, array: np.ndarray, parent: str):
    """(torch name, array) for one flax leaf inside the module ``parent``."""
    if name == "kernel":
        if array.ndim == 4:  # Conv (kh, kw, in, out) -> (out, in, kh, kw)
            return "weight", array.transpose(3, 2, 0, 1)
        if array.ndim == 3 and parent == "out":  # DenseGeneral (H, D, E)
            return "weight", array.reshape(-1, array.shape[-1]).T
        if array.ndim == 3:  # DenseGeneral (E, H, D)
            return "weight", array.reshape(array.shape[0], -1).T
        return "weight", array.T
    if name == "bias":  # DenseGeneral biases are (H, D)
        return name, array.reshape(-1)
    if name == "scale":
        return "weight", array
    return _rename(name), array


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into the port's state_dict names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: list, parent: str):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [_rename(name)], name)
                continue
            key, array = _convert_leaf(name, np.asarray(value, dtype=np.float32), parent)
            out[".".join(prefix + [key])] = torch.from_numpy(np.array(array, order="C"))

    walk(params, [], "")
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Load a flax parameter tree into ``model`` strictly (in place)."""
    converted = flax_to_state_dict(params)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(converted))
    unexpected = sorted(set(converted) - set(expected))
    if missing or unexpected:
        raise KeyError(
            f"flax tree does not match the model: missing {missing}, "
            f"unexpected {unexpected}"
        )
    for key, value in converted.items():
        if value.shape != expected[key].shape:
            raise ValueError(
                f"{key}: flax shape {tuple(value.shape)} != model shape "
                f"{tuple(expected[key].shape)}"
            )
    model.load_state_dict(converted, strict=True)


def flax_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """The flax tree path of each of ``model``'s parameters, by state_dict
    name: the inverse of ``flax_to_state_dict``'s names (an ``nn.Linear`` or
    ``nn.Conv2d`` ``weight`` is a ``kernel``, a LayerNorm's a ``scale``)."""
    modules = dict(model.named_modules())
    paths = {}
    for name, _ in model.named_parameters():
        parent, _, leaf = name.rpartition(".")
        module = modules[parent]
        parts = parent.split(".") if parent else []
        if isinstance(module, (nn.LayerNorm, FrozenBatchNorm)) and leaf == "weight":
            leaf = "scale"
        elif isinstance(module, (nn.Linear, nn.Conv2d)) and leaf == "weight":
            leaf = "kernel"
        elif isinstance(module, nn.ParameterList):  # ls1.{i} -> leaf ls1_{i}
            parts, leaf = parts[:-1], f"{parts[-1]}_{leaf}"
        paths[name] = _flax_modules(parts) + (leaf,)
    return paths


def _flax_modules(parts) -> Tuple[str, ...]:
    """The flax module path of a torch module path (split at its dots)."""
    path = []
    for part in parts:
        if part.isdigit() and path and _STACKED.match(f"{path[-1]}_{part}"):
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(_FLAX_AUTO_NAMES.get(part, part))
    return tuple(path)


# Both ViTs of the registry (RADIO-B/16: 768 / 12 heads, DINOv2-S/14: 384 /
# 6) have head dim 64; their DenseGeneral kernels are (E, H, 64) / (H, 64, E).
VIT_HEAD_DIM = 64
_VIT_ATTENTION = re.compile(r"^attn_\d+$")


def state_dict_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The flax parameter tree (nested dicts of numpy arrays) of a port
    ``state_dict``: ``flax_to_state_dict``'s inverse. A 1-D ``weight`` is a
    norm's ``scale``, a 2-D one a ``Dense`` kernel (transposed back), a 4-D
    one a ``Conv`` kernel (back to (kh, kw, in, out)); the ViT's attention
    projections become ``DenseGeneral`` kernels of head dim 64."""
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        array = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
                 else np.asarray(value))
        *parts, leaf = name.split(".")
        path = list(_flax_modules(parts))
        if leaf.isdigit():  # a ParameterList entry: ls1.{i} -> leaf ls1_{i}
            leaf = f"{path.pop()}_{leaf}"
        parent = path[-1] if path else ""
        vit_attention = (parent in ("query", "key", "value", "out") and len(path) > 1
                         and _VIT_ATTENTION.match(path[-2]) is not None)
        if leaf == "weight":
            if array.ndim == 1:
                leaf = "scale"
            elif array.ndim == 4:
                leaf, array = "kernel", array.transpose(2, 3, 1, 0)
            elif vit_attention and parent == "out":  # (E, H*D) -> (H, D, E)
                leaf, array = "kernel", array.T.reshape(-1, VIT_HEAD_DIM, array.shape[0])
            elif vit_attention:  # (H*D, E) -> (E, H, D)
                leaf, array = "kernel", array.T.reshape(array.shape[1], -1, VIT_HEAD_DIM)
            else:
                leaf, array = "kernel", array.T
        elif leaf == "bias" and vit_attention and parent != "out":
            array = array.reshape(-1, VIT_HEAD_DIM)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(array)
    return tree
