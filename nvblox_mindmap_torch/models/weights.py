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
  stacked layers ``attn_{i}`` / ``ffw_{i}`` -> ``attn.{i}`` / ``ffw.{i}``.

Loading is strict: a key left over on either side, or a shape that differs,
raises.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

AUTO_NAMES = {
    "MultiheadAttention_0": "attention",
    "LayerNorm_0": "norm",
    "AdaLN_0": "adaln",
    "Dense_0": "fc1",
    "Dense_1": "fc2",
}
_STACKED = re.compile(r"^(attn|ffw)_(\d+)$")


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into the port's state_dict names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: list):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                stacked = _STACKED.match(name)
                part = (f"{stacked[1]}.{stacked[2]}" if stacked
                        else AUTO_NAMES.get(name, name))
                walk(value, prefix + [part])
                continue
            array = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                name, array = "weight", array.T
            elif name == "scale":
                name = "weight"
            out[".".join(prefix + [name])] = torch.from_numpy(
                np.array(array, order="C")
            )

    walk(params, [])
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
