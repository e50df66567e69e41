"""The plain reference's replay of a humanoid closed-loop run: the same sim
steps and goals, from the same frames, masks, noise, seed and weights, in
the reference's arithmetic or the control's (``precision.arithmetic``).

It is ``drivers/closed_loop.reference_outputs`` for two hands and a
predicted head yaw: the gripper history holds both hands of the 17-d policy
state (left 8, right 8; the state's head yaw is not a model input), each
goal's noise is (1, 1, 2, 9), and a goal's answer is both hands'
trajectories (position, wxyz quaternion, openness) followed by the head yaw.
Every sim step masks the frame's ``robot`` pixels out of the static map, as
the task's mapping configuration asks.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from portbench import scene_humanoid
from portbench.drivers import common
from portbench.drivers.closed_loop import pixel_sample


def noise_bank(traffic: dict, seed: int, device, grippers: int) -> torch.Tensor:
    """(bank, 1, 1, grippers, 9) initial noises drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((traffic["noise_bank"], 1, 1, grippers, 9), generator=gen,
                       device=device)


def dynamic_mask(segmentation, labels) -> np.ndarray:
    """Pixels of the classes the mapping configuration calls dynamic."""
    seg = np.asarray(segmentation)
    mask = np.zeros(seg.shape, bool)
    for label, name in scene_humanoid.LABELS.items():
        if name in labels:
            mask |= seg == label
    return mask


def replay(run, st, goals, lowered: bool) -> dict:
    """Answers of the reference for the run's events (``st.events``: every
    sim step and goal, in order): the trajectories and head yaws of
    ``goals``, the last goal's surface, the last sim step's features at the
    sampled pixels."""
    from portbench.reference.data.vertex_sampling import (
        VertexSamplingMethod,
        sample_to_n_vertices,
    )
    from portbench.reference.geometry.np_rotations import pose7_to_matrix
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
        noise = noise_bank(tr, run.seed, dev, model.config.ngrippers)
        bounds = common.workspace(cfg)
        rng = np.random.default_rng(run.seed)
        history = collections.deque(maxlen=cfg["model"]["nhist"])
        budget = max(cfg["num_vertices_to_sample"], 4096)
        backbone = model.encoder.feature_extractor
        features = {}
        wanted, goal_index = set(goals), 0
        last_step_frame = next((e[1] for e in reversed(st.events) if e[0] == "step"), None)

        def feature_image(frame):
            if frame not in features:
                rgb = torch.as_tensor(st.frames[frame].rgb, device=dev).float()
                feats = resize_bilinear(backbone(rgb[None]), (size, size))[0]
                features[frame] = feats.half()
                if frame == last_step_frame:
                    out["features"] = feats.reshape(-1, feats.shape[-1])[
                        torch.as_tensor(pixel_sample(cfg, run.seed), device=dev)
                    ].float().cpu().numpy()
            return features[frame]

        def on_dev(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

        for event in st.events:
            if event[0] == "step":
                frame = st.frames[event[1]]
                mapper.decay()
                nvblox_integrate(mapper, mapping, frame.depth, feature_image(event[1]),
                                 frame.intrinsics, pose7_to_matrix(frame.pose7), frame.rgb,
                                 dynamic_mask=dynamic_mask(frame.segmentation,
                                                           mapping.dynamic_class_labels),
                                 include_dynamic=False)
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
                states = np.stack(list(history))[None]  # (1, nhist, 17)
                pose7 = np.asarray(frame.pose7)
                batch = {
                    "gripper_history": np.stack([states[..., :8], states[..., 8:16]], axis=-2),
                    "vertices": sampled[0][None].astype(np.float32),
                    "vertex_features": sampled[1][None].astype(np.float32),
                    "vertices_valid_mask": sampled[2][None],
                    "rgbs": np.asarray(frame.rgb, np.float32)[None, None],
                    "pcds": get_camera_pointcloud(on_dev(frame.intrinsics), on_dev(frame.depth),
                                                  on_dev(pose7[:3]), on_dev(pose7[3:]))[None, None],
                    "pcd_valid_mask": (np.asarray(frame.depth) > 0)[None, None],
                }
                prepared = prepare_inputs(batch, bounds, model.config, device=dev)
                traj, head_yaw, _ = sample_trajectory(
                    model, prepared, bounds, num_inference_steps=tr["inference_steps"],
                    scheduler_kind=tr["scheduler"], stochastic=False, init_noise=noise[bank])
                out["trajs"][goal_index] = torch.cat(
                    [traj.reshape(-1), head_yaw.reshape(-1)]).double().cpu().numpy()
            goal_index += 1
        if out["features"] is None and last_step_frame is not None:
            feature_image(last_step_frame)
    del model, mapper, features
    common.free(dev)
    return out
