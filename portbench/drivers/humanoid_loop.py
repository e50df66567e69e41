"""Closed-loop traffic of the GR1T2 humanoid: ``NvbloxDiffuserActorPolicy``
driving ``HumanoidEmbodiment`` as ``apps/run_closed_loop_policy.py`` builds
it for a GR1 task: the model from ``model_config_from_args`` for the
configuration's task, the pov (head) camera alone, the task's mapping
configuration at the camera's size, the serving sampler and flash attention.

The head camera's scripted sweep and both hands' reach
(``scene_humanoid``) are rendered in set-up, ``frames`` of them; the hands
are boxes labelled ``robot``, which the task's mapping configuration masks
out of the static map. Every sim step k fuses frame k mod ``frames``; after
every ``steps_per_goal``-th step a goal (both hands and the head yaw). The
predicted head yaw does not steer the replayed frames.

Every goal draws its initial noise, (1, 1, 2, 9), from a bank made from the
seed; the policy's own generator draws the vertices. ``correct`` compares
against the plain reference replaying the same steps and goals
(``reference/humanoid_replay.py``): a sample of the window's goals
(``goal_gap``, the median of their gaps, and ``goal_gap_max``, the widest;
a goal's gap is the widest over both hands and the head yaw), the last
goal's surface (``mesh_gap``) and the last sim step's features at a sample
of pixels (``features_gap``).

The run also keeps, for each goal of the window, the mapper's counters
``surface_vertices`` and ``live_pages`` of the static map (absent where the
program has none), in ``run.counters``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scene, scene_humanoid
from portbench.drivers import closed_loop, common
from portbench.reference.humanoid_replay import noise_bank, replay

# Reused as the arm's episode runs them: the steps and goals, the compared
# goals, the release of the program's state.
cycle_step = closed_loop.cycle_step
release = closed_loop.release
compared_goals = closed_loop.compared_goals


class Env(closed_loop.Env):
    """The arm's replayed camera as the humanoid's pov camera, over the
    humanoid scene's labels."""

    semantic_id_to_class = scene_humanoid.LABELS

    def get_cameras(self):
        return {"pov": self.frames[self.i]}


def scene_frames(config: dict, traffic: dict, device):
    """(frames, states) of the head sweep and the reach, rendered on
    ``device``."""
    size = config["image_size"]
    states = scene_humanoid.scripted_reach(traffic["frames"])
    poses = [scene_humanoid.head_camera(float(s[16])) for s in states]
    boxes = [scene_humanoid.STATIC_BOXES + tuple(scene_humanoid.hand_boxes(s)) for s in states]
    rgb, depth, seg = (x.cpu().numpy()
                       for x in scene_humanoid.render_frames(poses, boxes, size, device))
    K = scene.intrinsics(size)
    frames = [closed_loop.Frame(rgb[i], depth[i], K, poses[i], seg[i])
              for i in range(len(poses))]
    return frames, states


def model_config(config: dict):
    """The program's ``DiffuserActorConfig`` as the closed-loop app makes it
    for the configuration's task (``model_config_from_args``); raises where
    it differs from the configuration file's model fields."""
    from nvblox_mindmap_torch.utils.config import ModelArgs, model_config_from_args

    m = config["model"]
    args = ModelArgs(
        task=config["task"], embedding_dim=m["embedding_dim"],
        num_vis_ins_attn_layers=m["num_vis_ins_attn_layers"], num_history=m["nhist"],
        prediction_horizon=m["prediction_horizon"], data_type=m["data_type"],
        feature_type=m["feature_type"], feature_image_size=tuple(m["feature_image_size"]),
        fps_subsampling_factor=m["fps_subsampling_factor"],
        diffusion_timesteps=m["diffusion_timesteps"],
        rotation_parametrization=m["rotation_parametrization"],
        quaternion_format=m["quaternion_format"])
    cfg = model_config_from_args(args, vertex_feature_dim=m["vertex_feature_dim"])
    wrong = {k: (getattr(cfg, k), v) for k, v in common.model_fields(config).items()
             if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"model_config_from_args differs from the configuration: {wrong}")
    return cfg


def setup(run):
    from nvblox_mindmap_torch.closed_loop import policies
    from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
    from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor
    from nvblox_mindmap_torch.models.pretrained import backbone_feature_fn
    from nvblox_mindmap_torch.ops import flash_attention as fa

    cfg, tr, dev = run.config, run.traffic, run.device
    st = closed_loop.State()
    model_cfg = model_config(cfg)
    with torch.device(dev):
        st.model = DiffuserActor(model_cfg, device=dev)
    state = common.seeded_state({n: tuple(p.shape) for n, p in st.model.named_parameters()},
                                cfg, run.seed, dev)
    with torch.no_grad():
        for name, p in st.model.named_parameters():
            p.copy_(state[name])
    del state
    size = cfg["image_size"]
    st.mapping = MappingConfig.for_task(cfg["task"], **cfg["mapping"]).scaled_for_image_size(
        (size, size))
    st.policy = policies.NvbloxDiffuserActorPolicy(
        st.model, HumanoidEmbodiment(), st.mapping, common.workspace(cfg),
        num_vertices_to_sample=cfg["num_vertices_to_sample"],
        feature_fn=backbone_feature_fn(st.model.encoder.feature_extractor, (size, size)),
        num_history=cfg["model"]["nhist"], seed=run.seed,
        num_inference_steps=tr["inference_steps"], scheduler_kind=tr["scheduler"],
        stochastic_sampling=False, device=dev)
    if apply_inference_settings(convert_to_flash_attention()):
        raise AssertionError("unexpected sampler settings")
    st.frames, st.states = scene_frames(cfg, tr, dev)
    st.env = Env(st.frames, st.states)
    st.noise = noise_bank(tr, run.seed, dev, model_cfg.ngrippers)
    st.pixels = torch.as_tensor(closed_loop.pixel_sample(cfg, run.seed), device=dev)
    st.events, st.trajs, st.steps, st.goals = [], [], 0, 0
    st.last_mesh = st.last_features = None
    st.counted = []  # (goal, surface vertices, live pages) of each goal
    robot = [int((f.segmentation == scene_humanoid.ROBOT).sum()) for f in st.frames]
    run.notes.update(robot_pixels_min=min(robot), robot_pixels_max=max(robot))

    policy, mapper = st.policy, st.policy.mapper
    predict, mesh_vertices, feature_fn = policy.predict, policy.mesh_vertices, policy.feature_fn

    def recording_predict(*args, **kwargs):
        traj, head_yaw = predict(*args, **kwargs)
        st.trajs.append(np.concatenate([np.asarray(traj, np.float64).reshape(-1),
                                        np.asarray(head_yaw, np.float64).reshape(-1)]))
        return traj, head_yaw

    def recording_mesh():
        st.last_mesh = mesh_vertices()
        vertices = getattr(mapper, "surface_vertices", {}).get(MapperId.STATIC)
        pages = getattr(mapper, "live_pages", {}).get(MapperId.STATIC)
        if vertices is not None and pages is not None:
            st.counted.append((st.goals, vertices, pages))
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
        fa.run_kernel = closed_loop.flash_recorder(run, fa.run_kernel)

    spg = tr["steps_per_goal"]
    run.warm_up(lambda: [cycle_step(st, spg) for _ in range(spg)])
    st.window_goal0 = st.goals
    return st


def window(run, st) -> None:
    """The arm's episode window, then the counters of the window's goals."""
    closed_loop.window(run, st)
    kept = [c for c in st.counted if c[0] >= st.window_goal0]
    run.counters = {"surface_vertices": [c[1] for c in kept],
                    "live_pages": [c[2] for c in kept]} if kept else {}


def gaps(program: dict, reference: dict, goals) -> dict:
    """Gaps between two sides' answers. A goal's gap is the widest over both
    hands (position in m, wxyz quaternion up to sign, openness probability)
    and the head yaw (rad); ``goal_gap`` is their median over the compared
    goals, ``goal_gap_max`` the widest. The surface (vertices and features;
    infinite when the counts differ) and the feature samples by their
    widest gaps, as in ``closed_loop.gaps``."""
    per_goal = []
    for g in goals:
        a, b = program["trajs"][g], reference["trajs"][g]
        if a.shape != b.shape:
            per_goal.append(math.inf)
            continue
        worst = abs(a[-1] - b[-1])
        for h in range(0, len(a) - 1, 8):
            pa, pb = a[h:h + 8], b[h:h + 8]
            quat = min(np.abs(pa[3:7] - pb[3:7]).max(), np.abs(pa[3:7] + pb[3:7]).max())
            worst = max(worst, np.abs(pa[:3] - pb[:3]).max(), quat, abs(pa[7] - pb[7]))
        per_goal.append(float(worst))
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
    return gaps(program, replay(run, st, goals, lowered=False), goals)


def control(run, st) -> dict:
    """The control's readings: the reference in the control's arithmetic
    (``reference/precision.py``) put in the program's place, held to the
    reference by the same gaps."""
    goals = compared_goals(run, st)
    low = replay(run, st, goals, lowered=True)
    return gaps(low, replay(run, st, goals, lowered=False), goals)
