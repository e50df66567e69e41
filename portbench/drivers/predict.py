"""Prediction traffic: the open-loop app's inference function
(``apps/run_open_loop_policy.make_infer_fn``) over a model built as the app
builds it (``ModelArgs`` of the configuration, ``model_config_from_args``,
the flash attention impl), one goal after another at batch size 1.

A goal is one ``infer(batch, seed)`` call: ``prepare_inputs`` of the host
batch, the encoder, and the stochastic DDPM sampler at the training
timestep count from the noise of the goal's seed
(``reference/predict_replay.goal_seed``); it ends when the trajectory is on
the host. Goal g reads keyframe g mod ``frames`` and instruction g mod
``instructions`` (``scene_peract``, made in set-up and kept on the host).
Traffic parameters (``traffic/<name>.json``): ``frames``, ``instructions``,
``instruction_tokens``, and the harness's warm-up, trace and compare keys.

``correct`` compares, against the plain reference replaying the same goals
(``reference/predict_replay.py``): a sample of the window's goals
(``goal_gap``, the median of their gaps, and ``goal_gap_max``, the widest)
and the extractor's features of the last goal's images at a sample of
positions (``features_gap``); each number where ``limits/<cell>.json``
names it.

The run keeps, for each goal of the window, the encoder's counters
``context_tokens`` and ``fps_kept`` (absent where the program has none), in
``run.counters``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import roofline, scene_peract
from portbench.drivers import closed_loop, common
from portbench.reference.predict_replay import goal_seed, replay, sampled_features

COUNTERS = ("context_tokens", "fps_kept")


def model_args(config: dict):
    """The app's ``ModelArgs`` for the configuration file."""
    from nvblox_mindmap_torch.utils.config import ModelArgs

    m = config["model"]
    return ModelArgs(
        data_type=m["data_type"], feature_type=m["feature_type"],
        image_size=(config["image_size"], config["image_size"]),
        feature_image_size=tuple(m["feature_image_size"]),
        use_instruction=int(m["use_instruction"]), lang_enhanced=int(m["lang_enhanced"]),
        embedding_dim=m["embedding_dim"], num_vis_ins_attn_layers=m["num_vis_ins_attn_layers"],
        fps_subsampling_factor=m["fps_subsampling_factor"], num_history=m["nhist"],
        prediction_horizon=m["prediction_horizon"],
        diffusion_timesteps=m["diffusion_timesteps"],
        rotation_parametrization=m["rotation_parametrization"],
        quaternion_format=m["quaternion_format"])


def model_config(config: dict):
    """The program's ``DiffuserActorConfig`` from ``model_config_from_args``;
    raises where it differs from the configuration file's model fields."""
    from nvblox_mindmap_torch.utils.config import model_config_from_args

    cfg = model_config_from_args(model_args(config))
    wrong = {k: (getattr(cfg, k), v) for k, v in common.model_fields(config).items()
             if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"model_config_from_args differs from the configuration: {wrong}")
    return cfg


def setup(run):
    from nvblox_mindmap_torch.apps.run_open_loop_policy import make_infer_fn
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor
    from nvblox_mindmap_torch.ops import flash_attention as fa

    cfg, tr, dev = run.config, run.traffic, run.device
    st = closed_loop.State()
    with torch.device(dev):
        st.model = DiffuserActor(model_config(cfg), device=dev)
    state = common.seeded_state({n: tuple(p.shape) for n, p in st.model.named_parameters()},
                                cfg, run.seed, dev)
    with torch.no_grad():
        for name, p in st.model.named_parameters():
            p.copy_(state[name])
    del state
    if apply_inference_settings(convert_to_flash_attention()):
        raise AssertionError("unexpected sampler settings")
    st.infer = make_infer_fn(st.model, common.workspace(cfg))
    st.frames = scene_peract.keyframes(tr["frames"], cfg["image_size"], cfg["model"]["nhist"],
                                       run.seed, dev)
    st.instructions = scene_peract.instructions(tr["instructions"], tr["instruction_tokens"],
                                                run.seed, dev)
    st.events, st.trajs, st.counted, st.goals = [], [], [], 0
    st.restore = [(fa, "run_kernel", fa.run_kernel)]
    if run.trace:
        fa.run_kernel = closed_loop.flash_recorder(run, fa.run_kernel)
    run.warm_up(lambda: goal(run, st))
    if run.trace:
        st.model_flops = goal_flops(run, st)
    st.window_goal0 = st.goals
    return st


def batch_of(st, g: int):
    """(batch, keyframe, instruction) of goal ``g``."""
    frame, instruction = g % len(st.frames), g % len(st.instructions)
    return (dict(st.frames[frame], instruction=st.instructions[instruction]), frame,
            instruction)


def goal(run, st) -> None:
    batch, frame, instruction = batch_of(st, st.goals)
    traj, _, _ = st.infer(batch, goal_seed(run.seed, st.goals))
    st.trajs.append(traj.double().cpu().numpy().reshape(-1))
    encoder = st.model.encoder
    st.counted.append(tuple(getattr(encoder, name, None) for name in COUNTERS))
    st.events.append((frame, instruction))
    st.goals += 1


def goal_flops(run, st) -> int:
    """FLOPs of one goal on the eager attention path (the same work as the
    kernels')."""
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    batch, _, _ = batch_of(st, 0)
    set_default_attention_impl("eager")
    try:
        return roofline.count_flops(lambda: st.infer(batch, goal_seed(run.seed, 0)))
    finally:
        set_default_attention_impl("flash")


def flash_bound_s(calls) -> float:
    """The summed bounds of the recorded flash calls."""
    return sum(roofline.attention_bound_s(B, H, L, S, D, size,
                                          None if valid is None else int(valid), masked)
               for B, H, L, D, S, size, valid, masked in calls)


def window(run, st) -> None:
    """Goals until the window's seconds have passed and at least two goals
    are done (a 90th percentile needs two; on the card a window holds
    hundreds)."""
    run.open_window()
    while run.more() or run.counts.get("goal", 0) < 2:
        with run.unit("goal"):
            goal(run, st)
    run.close_window()
    run.attempted = run.counts.get("goal", 0)
    run.failed = sum(not np.isfinite(t).all() for t in st.trajs[st.window_goal0:])
    run.flops["goal"] = getattr(st, "model_flops", None)
    run.flash_bound_s = flash_bound_s(run.flash_calls)
    kept = [c for c in st.counted[st.window_goal0:] if None not in c]
    run.counters = ({name: [c[i] for c in kept] for i, name in enumerate(COUNTERS)}
                    if kept else {})
    run.notes.update(goals=st.goals, window_goals=st.goals - st.window_goal0,
                     flops_per_goal=run.flops["goal"], flash_calls=len(run.flash_calls))
    # The program's extractor on the last goal's images, for ``features_gap``.
    last = st.events[-1][0]
    st.features_program = sampled_features(st.model.encoder.feature_extractor,
                                           st.frames[last]["rgbs"], run.seed, run.device)


def release(run, st) -> None:
    for module, name, original in st.restore:
        setattr(module, name, original)
    del st.model, st.infer
    common.free(run.device)


def gaps(program: dict, reference: dict, goals) -> dict:
    """The closed loop's gaps (``closed_loop.gaps``: each goal's widest
    trajectory gap, their median and widest, the sampled features' widest),
    without a surface to compare."""
    out = closed_loop.gaps(dict(program, mesh=None), dict(reference, mesh=None), goals)
    del out["mesh_gap"]
    return out


def check(run, st) -> dict:
    goals = closed_loop.compared_goals(run, st)
    if not goals:
        return {"goal_gap": math.inf}
    program = {"trajs": {g: st.trajs[g] for g in goals}, "features": st.features_program}
    return gaps(program, replay(run, st, goals, lowered=False), goals)


def control(run, st) -> dict:
    """The control's readings: the reference in the control's arithmetic
    (``reference/precision.py``) put in the program's place, held to the
    reference by the same gaps."""
    goals = closed_loop.compared_goals(run, st)
    low = replay(run, st, goals, lowered=True)
    return gaps(low, replay(run, st, goals, lowered=False), goals)
