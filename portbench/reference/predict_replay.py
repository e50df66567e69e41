"""The plain reference's replay of a prediction run: the same goals, from the
same host batches, seed-drawn noise and weights, in the reference's
arithmetic or the control's (``precision.arithmetic``), on the run's device.

A goal g of a run with seed s is one prediction of the stochastic DDPM
sampler at the training timestep count, from the noise of seed
``goal_seed(s, g)``: a generator on the device seeded with it draws the
initial trajectory (1, L, G, 9), then the step noise (T, 1, L, G, 9), as
the open-loop app's ``sampler_noise`` draws them. The replay returns the
trajectories of the goals asked for (position, quaternion in the
configuration's order, openness) and the extractor's features of the last
goal's images at a sample of their feature positions.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.drivers import common

FEATURES = 4096  # feature positions of the last goal held to the program


def goal_seed(seed: int, goal: int) -> int:
    """The sampler's seed of goal ``goal`` in a run of seed ``seed``."""
    return (int(seed) << 20) + int(goal)


def noise(seed: int, steps: int, shape, device):
    """(initial noise (*shape, 9), step noise (steps, *shape, 9)) of one
    seed, in the open-loop app's order of draws."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    init = torch.randn(tuple(shape) + (9,), generator=gen, device=device)
    return init, torch.randn((steps,) + tuple(shape) + (9,), generator=gen, device=device)


def feature_sample(count: int, seed: int) -> np.ndarray:
    """The feature positions (of ``count``, all images flattened) held to
    the program, drawn from the seed."""
    return np.random.default_rng(seed).choice(count, min(FEATURES, count), replace=False)


def sampled_features(extractor, rgbs, seed: int, device) -> np.ndarray:
    """``extractor``'s features of a (1, ncam, H, W, 3) uint8 batch of images
    (scaled to [0, 1] on the device, as the model's inputs are) at the
    sampled positions, float32 (positions, C) on the host."""
    rgb = torch.as_tensor(np.asarray(rgbs), device=device)
    rgb = rgb.reshape(-1, *rgb.shape[2:]).to(torch.float32) / 255.0
    with torch.no_grad():
        feats = extractor(rgb)
    feats = feats.reshape(-1, feats.shape[-1])
    picked = torch.as_tensor(feature_sample(feats.shape[0], seed), device=device)
    return feats[picked].float().cpu().numpy()


def replay(run, st, goals, lowered: bool) -> dict:
    """Answers of the reference for the goals ``goals`` of the run
    (``st.events[g]``: the keyframe and instruction of goal g, read from
    ``st.frames`` and ``st.instructions``): their trajectories, and the last
    goal's features at the sampled positions."""
    from portbench.reference.models.diffuser_actor import (
        DiffuserActor,
        DiffuserActorConfig,
        prepare_inputs,
        sample_trajectory,
    )
    from portbench.reference.precision import arithmetic

    cfg, dev = run.config, run.device
    out = {"trajs": {}, "features": None}
    with arithmetic(lowered), torch.no_grad():
        model = common.build_model(DiffuserActor, DiffuserActorConfig, cfg, run.seed, dev)
        bounds = common.workspace(cfg)
        steps = model.config.diffusion_timesteps
        shape = (1, model.config.prediction_horizon, model.config.ngrippers)
        for g in goals:
            frame, instruction = st.events[g]
            batch = dict(st.frames[frame], instruction=st.instructions[instruction])
            prepared = prepare_inputs(batch, bounds, model.config, device=dev)
            init, step = noise(goal_seed(run.seed, g), steps, shape, dev)
            traj, _, _ = sample_trajectory(model, prepared, bounds, scheduler_kind="ddpm",
                                           stochastic=True, init_noise=init, step_noise=step)
            out["trajs"][g] = traj.double().cpu().numpy().reshape(-1)
        last = st.events[st.goals - 1][0]
        out["features"] = sampled_features(model.encoder.feature_extractor,
                                           st.frames[last]["rgbs"], run.seed, dev)
    del model
    common.free(dev)
    return out
