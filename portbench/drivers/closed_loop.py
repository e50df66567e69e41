"""Closed-loop traffic: ``NvbloxDiffuserActorPolicy`` driven by one robot's
loop, as ``apps/run_closed_loop_policy.py`` builds it (the serving sampler,
flash attention, the task's mapping configuration at the camera's size).

The scene's ego-camera frames along the scripted pick are rendered in
set-up. Traffic parameters (``traffic/<name>.json``):

- ``steps_per_goal`` 0: back-to-back goals. Set-up fuses ``frames`` sim
  steps into the map; each goal of the window starts when the last returns,
  and goal g sees frame g mod ``frames`` and the gripper state there;
- ``steps_per_goal`` n > 0: an episode. Every sim step k fuses frame
  k mod ``frames`` (``policy.step``: decay, features, fusion); after every
  n-th step a goal.

Every goal draws its initial noise from a bank made from the seed; the
policy's own generator (seeded with the seed) draws the vertices.
``correct`` compares, against the plain reference replaying the same steps
and goals from the same frames, seed and weights: a sample of the window's
goals (``goal_gap``, the median of their gaps, and ``goal_gap_max``, the
widest), the surface vertices and features of the last goal (``mesh_gap``)
and the extractor's features of the last sim step at a sample of pixels
(``features_gap``); each number where ``limits/<cell>.json`` names it.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch

from portbench import roofline, scene
from portbench.drivers import common

PIXELS = 4096  # pixels of a feature image held to the reference


class Frame:
    def __init__(self, rgb, depth, intrinsics, pose7, segmentation):
        self.rgb, self.depth, self.intrinsics = rgb, depth, intrinsics
        self.pose7, self.segmentation = pose7, segmentation


class Env:
    """One ego camera over pre-rendered frames, and the arm's policy state
    at each; ``at(i)`` moves both to frame i mod the count."""

    semantic_id_to_class = scene.SCENE_LABELS

    def __init__(self, frames, states):
        self.frames, self.states, self.i = frames, states, 0

    def at(self, i: int) -> None:
        self.i = i % len(self.frames)

    def get_cameras(self):
        return {"wrist": self.frames[self.i]}

    def get_policy_state(self):
        return self.states[self.i]


def scene_frames(config: dict, traffic: dict, device):
    """(frames, states) of the scripted pick, rendered on ``device``."""
    size = config["image_size"]
    states = scene.scripted_pick(traffic["frames"])
    poses = [scene.wrist_camera(s) for s in states]
    rgb, depth, seg = (x.cpu().numpy() for x in scene.render_frames(poses, size, device))
    K = scene.intrinsics(size)
    frames = [Frame(rgb[i], depth[i], K, poses[i], seg[i]) for i in range(len(poses))]
    return frames, states


def noise_bank(traffic: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((traffic["noise_bank"], 1, 1, 1, 9), generator=gen, device=device)


def pixel_sample(config: dict, seed: int) -> np.ndarray:
    size = config["image_size"]
    return np.random.default_rng(seed).choice(size * size, min(PIXELS, size * size),
                                              replace=False)


class State:
    pass


def setup(run):
    from nvblox_mindmap_torch.closed_loop import policies
    from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
    from nvblox_mindmap_torch.mapping.constants import MappingConfig
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor, DiffuserActorConfig
    from nvblox_mindmap_torch.models.pretrained import backbone_feature_fn
    from nvblox_mindmap_torch.ops import flash_attention as fa

    cfg, tr, dev = run.config, run.traffic, run.device
    st = State()
    st.model = common.build_model(DiffuserActor, DiffuserActorConfig, cfg, run.seed, dev)
    size = cfg["image_size"]
    st.mapping = MappingConfig.for_task(cfg["task"], **cfg["mapping"]).scaled_for_image_size(
        (size, size))
    st.policy = policies.NvbloxDiffuserActorPolicy(
        st.model, ArmEmbodiment(), st.mapping, common.workspace(cfg),
        num_vertices_to_sample=cfg["num_vertices_to_sample"],
        feature_fn=backbone_feature_fn(st.model.encoder.feature_extractor, (size, size)),
        num_history=cfg["model"]["nhist"], seed=run.seed,
        num_inference_steps=tr["inference_steps"], scheduler_kind=tr["scheduler"],
        stochastic_sampling=False, device=dev)
    if apply_inference_settings(convert_to_flash_attention()):
        raise AssertionError("unexpected sampler settings")
    st.frames, st.states = scene_frames(cfg, tr, dev)
    st.env = Env(st.frames, st.states)
    st.noise = noise_bank(tr, run.seed, dev)
    st.pixels = torch.as_tensor(pixel_sample(cfg, run.seed), device=dev)
    st.events, st.trajs, st.steps, st.goals = [], [], 0, 0
    st.last_mesh = st.last_features = None

    policy = st.policy
    predict, mesh_vertices, feature_fn = policy.predict, policy.mesh_vertices, policy.feature_fn

    def recording_predict(*args, **kwargs):
        traj, head_yaw = predict(*args, **kwargs)
        st.trajs.append(np.asarray(traj, np.float64).reshape(-1))
        return traj, head_yaw

    def recording_mesh():
        st.last_mesh = mesh_vertices()
        return st.last_mesh

    def recording_features(rgb):
        out = feature_fn(rgb)
        st.last_features = out.reshape(-1, out.shape[-1])[st.pixels]
        return out

    policy.predict = recording_predict
    policy.mesh_vertices = run.wrap_span("mesh", recording_mesh)
    policy.feature_fn = run.wrap_span("features", recording_features)
    st.restore = [(policies, "sample_trajectory", policies.sample_trajectory),
                  (policies, "nvblox_integrate", policies.nvblox_integrate),
                  (fa, "run_kernel", fa.run_kernel)]
    if run.trace:
        policies.sample_trajectory = run.wrap_span("sampler", policies.sample_trajectory)
        policies.nvblox_integrate = run.wrap_span("fuse", policies.nvblox_integrate)
        fa.run_kernel = flash_recorder(run, fa.run_kernel)

    spg = tr["steps_per_goal"]
    if spg == 0:
        for _ in range(tr["frames"]):
            sim_step(st)
        run.warm_up(lambda: goal(st))
        if run.trace:
            st.model_flops = goal_flops(st)
    else:
        run.warm_up(lambda: [cycle_step(st, spg) for _ in range(spg)])
    st.window_goal0 = st.goals
    return st


def flash_recorder(run, run_kernel):
    """``run_kernel`` recording each call's shape, element size, valid keys
    (a device tensor, read after the window) and whether it was masked,
    while the profiler runs."""
    def recorded(name, q, k, v, key_padding_mask=None):
        out = run_kernel(name, q, k, v, key_padding_mask)
        if run.profiling:
            valid = None if key_padding_mask is None else key_padding_mask.sum()
            run.flash_calls.append((*q.shape, k.shape[2], q.element_size(), valid,
                                    key_padding_mask is not None))
        return out

    return recorded


def sim_step(st) -> None:
    frame = st.steps % len(st.frames)
    st.env.at(frame)
    st.policy.step(st.env)
    st.events.append(("step", frame))
    st.steps += 1


def goal(st, frame=None) -> None:
    frame = st.goals % len(st.frames) if frame is None else frame
    bank = st.goals % len(st.noise)
    st.env.at(frame)
    st.policy.get_new_goal(st.env, init_noise=st.noise[bank])
    st.events.append(("goal", frame, bank))
    st.goals += 1


def cycle_step(st, spg: int, run=None) -> None:
    """One sim step of the episode, and the goal that follows every
    ``spg``-th; timed as units when ``run`` is given."""
    if run is None:
        sim_step(st)
        if st.steps % spg == 0:
            goal(st, (st.steps - 1) % len(st.frames))
        return
    with run.unit("step"):
        sim_step(st)
    if st.steps % spg == 0:
        with run.unit("goal"):
            goal(st, (st.steps - 1) % len(st.frames))


def goal_flops(st) -> int:
    """FLOPs of one goal's prediction on the eager attention path (the same
    work as the kernels'), on inputs drawn apart from the policy's
    generator."""
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    policy = st.policy
    saved, policy._rng = policy._rng, np.random.default_rng(0)
    recorded = len(st.trajs)
    try:
        batch = policy._model_inputs(st.env)
        set_default_attention_impl("eager")
        flops = roofline.count_flops(lambda: policy.predict(batch, init_noise=st.noise[0]))
    finally:
        set_default_attention_impl("flash")
        policy._rng = saved
        del st.trajs[recorded:]
    return flops


def window(run, st) -> None:
    spg = run.traffic["steps_per_goal"]
    run.open_window()
    while run.more():
        if spg == 0:
            with run.unit("goal"):
                goal(st)
        else:
            cycle_step(st, spg, run)
    run.close_window()
    run.attempted = run.counts.get("goal", 0) + run.counts.get("step", 0)
    window_trajs = st.trajs[st.window_goal0:]
    run.failed = sum(not np.isfinite(t).all() for t in window_trajs)
    run.flops["goal"] = getattr(st, "model_flops", None)
    vertices = st.last_mesh[0] if st.last_mesh is not None else None
    run.notes.update(steps=st.steps, goals=st.goals, window_goals=st.goals - st.window_goal0,
                     surface_vertices=None if vertices is None else len(vertices),
                     crossings=st.policy.mapper.last_crossing_count,
                     live_pages=int(st.policy.mapper.states[0].num_pages),
                     flops_per_goal=run.flops["goal"], flash_calls=len(run.flash_calls))
    run.flash_bound_s = sum(
        roofline.attention_bound_s(B, H, L, S, D, size, None if valid is None else int(valid),
                                   masked)
        for B, H, L, D, S, size, valid, masked in run.flash_calls)


def release(run, st) -> None:
    for module, name, original in st.restore:
        setattr(module, name, original)
    st.features_program = (None if st.last_features is None
                           else st.last_features.float().cpu().numpy())
    del st.policy, st.model, st.env, st.last_features
    common.free(run.device)


def compared_goals(run, st) -> list:
    """The window's goals held to the reference: a sample drawn from the
    seed, and the last (whose surface is compared too)."""
    first, last = st.window_goal0, st.goals - 1
    if last < first:
        return []
    rng = np.random.default_rng(run.seed)
    count = min(run.traffic["compare_goals"], last - first + 1)
    picked = set(rng.choice(np.arange(first, last + 1), count, replace=False).tolist())
    return sorted(picked | {last})


def reference_outputs(run, st, goals, lowered: bool) -> dict:
    """The plain reference's answers for the same frames, seed and weights,
    in its own arithmetic or the control's (``lowered``):
    trajectories of ``goals``, the last goal's surface, the last sim step's
    features at the sampled pixels. It replays every step and goal of the
    run (each goal's vertex draw needs that goal's surface)."""
    from portbench.reference.geometry.np_rotations import pose7_to_matrix
    from portbench.reference.data.vertex_sampling import (
        VertexSamplingMethod,
        sample_to_n_vertices,
    )
    from portbench.reference.mapping.constants import MapperId, MappingConfig
    from portbench.reference.mapping.mapper import (
        Mapper,
        get_vertices_and_features,
        nvblox_integrate,
    )
    from portbench.reference.models.diffuser_actor import (
        DiffuserActor,
        DiffuserActorConfig,
        prepare_inputs,
        sample_trajectory,
    )
    from portbench.reference.models.feature_extractors import resize_bilinear
    from portbench.reference.ops.backprojection import get_camera_pointcloud
    from portbench.reference.precision import arithmetic

    cfg, tr, dev = run.config, run.traffic, run.device
    size = cfg["image_size"]
    out = {"trajs": {}, "mesh": None, "features": None}
    with arithmetic(lowered), torch.no_grad():
        model = common.build_model(DiffuserActor, DiffuserActorConfig, cfg, run.seed, dev)
        mapping = MappingConfig.for_task(cfg["task"], **cfg["mapping"]).scaled_for_image_size(
            (size, size))
        mapper = Mapper({MapperId.STATIC: mapping}, dev)
        noise = noise_bank(tr, run.seed, dev)
        bounds = common.workspace(cfg)
        rng = np.random.default_rng(run.seed)
        history = collections.deque(maxlen=cfg["model"]["nhist"])
        budget = max(cfg["num_vertices_to_sample"], 4096)
        backbone = model.encoder.feature_extractor
        features = {}
        wanted, goal_index = set(goals), 0
        last_step_frame = None

        def feature_image(frame):
            if frame not in features:
                rgb = torch.as_tensor(st.frames[frame].rgb, device=dev).float()
                feats = resize_bilinear(backbone(rgb[None]), (size, size))[0]
                features[frame] = feats.half()
                if frame == last_step_frame:
                    out["features"] = feats.reshape(-1, feats.shape[-1])[
                        torch.as_tensor(pixel_sample(cfg, run.seed), device=dev)].float().cpu().numpy()
            return features[frame]

        last_step_frame = next((e[1] for e in reversed(st.events) if e[0] == "step"), None)
        for event in st.events:
            if event[0] == "step":
                frame = st.frames[event[1]]
                mapper.decay()
                seg = np.asarray(frame.segmentation)
                dynamic = np.zeros(seg.shape, bool)
                for label, name in scene.SCENE_LABELS.items():
                    if name in mapping.dynamic_class_labels:
                        dynamic |= seg == label
                nvblox_integrate(mapper, mapping, frame.depth, feature_image(event[1]),
                                 frame.intrinsics, pose7_to_matrix(frame.pose7), frame.rgb,
                                 dynamic_mask=dynamic, include_dynamic=False)
                continue
            _, frame_i, bank = event
            frame = st.frames[frame_i]
            state = np.asarray(st.states[frame_i], np.float32)
            if not history:
                history.extend([state] * history.maxlen)
            else:
                history.append(state)
            mapper.update_feature_mesh(MapperId.STATIC, max_vertices=budget)
            while mapper.last_crossing_count > budget and budget < 65536:
                budget = min(2 * budget, 65536)
                mapper.update_feature_mesh(MapperId.STATIC, max_vertices=budget)
            vertices, feats = get_vertices_and_features(mapper, MapperId.STATIC,
                                                        remove_zero_features=True)
            sampled = sample_to_n_vertices(vertices, feats, cfg["num_vertices_to_sample"],
                                           VertexSamplingMethod.RANDOM_WITHOUT_REPLACEMENT, rng)
            if goal_index == st.goals - 1:
                out["mesh"] = (vertices, feats)
            if goal_index in wanted:
                def on_dev(x):
                    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

                pose7 = np.asarray(frame.pose7)
                batch = {
                    "gripper_history": np.stack(list(history))[None][..., None, :],
                    "vertices": sampled[0][None].astype(np.float32),
                    "vertex_features": sampled[1][None].astype(np.float32),
                    "vertices_valid_mask": sampled[2][None],
                    "rgbs": np.asarray(frame.rgb, np.float32)[None, None],
                    "pcds": get_camera_pointcloud(on_dev(frame.intrinsics), on_dev(frame.depth),
                                                  on_dev(pose7[:3]), on_dev(pose7[3:]))[None, None],
                    "pcd_valid_mask": (np.asarray(frame.depth) > 0)[None, None],
                }
                prepared = prepare_inputs(batch, bounds, model.config, device=dev)
                traj, _, _ = sample_trajectory(
                    model, prepared, bounds, num_inference_steps=tr["inference_steps"],
                    scheduler_kind=tr["scheduler"], stochastic=False, init_noise=noise[bank])
                out["trajs"][goal_index] = traj.double().cpu().numpy().reshape(-1)
            goal_index += 1
        if out["features"] is None and last_step_frame is not None:
            feature_image(last_step_frame)
    del model, mapper, features
    common.free(dev)
    return out


def gaps(program: dict, reference: dict, goals) -> dict:
    """Gaps between two sides' answers. Each goal's gap is the widest of its
    trajectory's (position in m, wxyz quaternion up to sign, openness
    probability); ``goal_gap`` is their median over the compared goals,
    ``goal_gap_max`` the widest. (Over CLIP features, rounding that flips
    one of FPS's near-tied picks moves a lone goal by up to 1e-2, so a CLIP
    cell compares the median alone; over the bf16 ViT's it moves none.) The surface (vertices and features;
    infinite when the counts differ) and the feature samples by their
    widest gaps."""
    per_goal = []
    for g in goals:
        a, b = program["trajs"][g], reference["trajs"][g]
        quat = min(np.abs(a[3:7] - b[3:7]).max(), np.abs(a[3:7] + b[3:7]).max())
        per_goal.append(max(np.abs(a[:3] - b[:3]).max(), quat, abs(a[7] - b[7])))
    mesh_gap = features_gap = math.inf
    if program["mesh"] is not None and reference["mesh"] is not None:
        (va, fa), (vb, fb) = program["mesh"], reference["mesh"]
        if va.shape == vb.shape and fa.shape == fb.shape:
            mesh_gap = float(max(np.abs(va - vb).max(initial=0.0),
                                 np.abs(fa.astype(np.float64) - fb).max(initial=0.0)))
    if program["features"] is not None and reference["features"] is not None:
        features_gap = float(np.abs(program["features"] - reference["features"]).max())
    return {"goal_gap": float(np.median(per_goal)), "goal_gap_max": float(max(per_goal)),
            "goals_compared": float(len(per_goal)), "mesh_gap": mesh_gap,
            "features_gap": features_gap}


def check(run, st) -> dict:
    goals = compared_goals(run, st)
    if not goals:
        return {"goal_gap": math.inf}
    program = {"trajs": {g: st.trajs[g] for g in goals}, "mesh": st.last_mesh,
               "features": st.features_program}
    reference = reference_outputs(run, st, goals, lowered=False)
    return gaps(program, reference, goals)


def control(run, st) -> dict:
    """The control's readings: the reference in the control's arithmetic
    (``reference/precision.py``) put in the program's place, held to the
    reference by the same gaps."""
    goals = compared_goals(run, st)
    low = reference_outputs(run, st, goals, lowered=True)
    return gaps(low, reference_outputs(run, st, goals, lowered=False), goals)
