"""Pieces the drivers share: the model of a configuration file with the
benchmark's seeded weights, on either side."""
from __future__ import annotations

import numpy as np
import torch

from portbench import weights

CLIP_TRUNK = "encoder.feature_extractor.backbone."


def model_fields(config: dict) -> dict:
    fields = dict(config["model"])
    fields["feature_image_size"] = tuple(fields["feature_image_size"])
    return fields


def seeded_state(shapes: dict, config: dict, seed: int, device) -> dict:
    """The benchmark's weights for parameters of these shapes: one draw from
    ``seed``, then a CLIP trunk's BatchNorm statistics calibrated."""
    state = weights.random_state_dict(shapes, seed, device)
    if any(name.startswith(CLIP_TRUNK) for name in state):
        weights.calibrate_batchnorm(state, CLIP_TRUNK, config["image_size"], seed, device)
    return state


def build_model(actor_cls, config_cls, config: dict, seed: int, device):
    """A ``DiffuserActor`` (the program's or the reference's class) of the
    configuration, built on ``device`` and loaded with the seeded weights."""
    with torch.device(device):
        model = actor_cls(config_cls(**model_fields(config)), device=device)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    state = seeded_state(shapes, config, seed, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])
    del state
    return model


def workspace(config: dict) -> np.ndarray:
    return np.asarray(config["workspace_bounds"], np.float32)


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
