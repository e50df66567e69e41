"""Closed-loop policies: live mapping plus keypose prediction, and the
ground-truth and goal-sequence policies.

Port of ``nvblox_mindmap_tpu/closed_loop/policies.py`` (upstream
``closed_loop/policies/*``):

- ``GroundTruthPolicy``: serves a recorded demo's keyposes in order (demo
  validation, the ``execute_gt_goals`` mode), read through the port's
  ``DemoDataset`` and keypose detection;
- ``GoalPolicy`` and ``get_dummy_policy_for_embodiment``: a hardcoded goal
  sequence;

- ``NvbloxDiffuserActorPolicy.step``, every sim step: decay the map and
  fuse each camera (TSDF, color, deep features);
- ``get_new_goal``, on every goal request: extract the feature mesh, sample
  the vertex budget, back-project the RGB-D cameras, and run the reverse
  diffusion sampler on the model's device;
- ``aggregate_trajectory_samples`` and ``trajectory_to_policy_states``.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nvblox_mindmap_torch.closed_loop.environment import (
    EnvironmentBase,
    dynamic_mask_from_segmentation,
)
from nvblox_mindmap_torch.data.dataset import DemoDataset
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.data.vertex_sampling import (
    VertexSamplingMethod,
    sample_to_n_vertices,
)
from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType
from nvblox_mindmap_torch.geometry.np_rotations import pose7_to_matrix
from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
from nvblox_mindmap_torch.mapping.mapper import (
    Mapper,
    get_vertices_and_features,
    nvblox_integrate,
)
from nvblox_mindmap_torch.models.diffuser_actor import (
    DiffuserActor,
    prepare_inputs,
    sample_trajectory,
)
from nvblox_mindmap_torch.models.pretrained import make_feature_fn
from nvblox_mindmap_torch.ops.backprojection import get_camera_pointcloud
from nvblox_mindmap_torch.utils.timers import span

# Surface-extraction budget cap: the datagen extraction default, so live
# meshes never hold more of the scene than the training meshes did.
MESH_BUDGET_CAP = 65536


class PolicyBase:
    def step(self, env: EnvironmentBase) -> None:
        """Called every sim step (e.g. map update)."""

    def get_new_goal(self, env: EnvironmentBase) -> List[np.ndarray]:
        """Return the next goal policy state(s)."""
        raise NotImplementedError


class GroundTruthPolicy(PolicyBase):
    """Serves recorded keypose policy states in order."""

    def __init__(self, keypose_policy_states: np.ndarray):
        self.goals = list(np.asarray(keypose_policy_states))
        self._next = 0

    @classmethod
    def from_demo(
        cls,
        demo_path: str,
        embodiment: EmbodimentBase,
        extra_keyposes_around_grasp_events,
        keypose_detection_mode: KeyposeDetectionMode,
    ) -> "GroundTruthPolicy":
        robot_states = DemoDataset.load_robot_states(demo_path)
        keyposes = embodiment.extract_keypose_indices(
            robot_states, extra_keyposes_around_grasp_events, keypose_detection_mode
        )
        policy_states = embodiment.policy_states_from_robot_states(
            robot_states, use_keyposes=True
        )
        return cls(policy_states[keyposes])

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.goals)

    def get_new_goal(self, env: EnvironmentBase) -> List[np.ndarray]:
        if self.exhausted:
            return []
        goal = self.goals[self._next]
        self._next += 1
        return [goal]


class GoalPolicy(PolicyBase):
    """Executes a hardcoded sequence of goal policy states
    (reference: closed_loop/policies/goal_policy.py:24-71).

    Args:
        goal_states: list of flat policy-state arrays (embodiment codec).
        repeat: cycle the sequence when exhausted; otherwise emit [] once done
            (the reference returns [None]; our runner treats [] as no-goal).
    """

    def __init__(self, goal_states: List[np.ndarray], repeat: bool = True):
        self.goal_states = [np.asarray(g, np.float32) for g in goal_states]
        self.repeat = repeat
        self.reset()

    def get_new_goal(self, env: EnvironmentBase) -> List[np.ndarray]:
        if not self.goal_states:
            return []
        if self.current_goal_idx == len(self.goal_states):
            if not self.repeat:
                return []
            self.current_goal_idx = 0
        goal = self.goal_states[self.current_goal_idx]
        self.current_goal_idx += 1
        return [goal]

    def reset(self) -> None:
        self.current_goal_idx = 0


def get_dummy_policy_for_embodiment(embodiment_type) -> GoalPolicy:
    """Test policy with the reference's hardcoded goal sequences
    (goal_policy.py:74-139): the arm oscillates along y in front of the
    robot; the humanoid moves both hands up/down while turning the head.
    Policy states use the flat embodiment codecs
    (arm: pos3+quat4+closedness; humanoid: left 8 + right 8 + head yaw)."""
    if embodiment_type == EmbodimentType.ARM:
        goals = [
            np.asarray([0.6, 0.25, 0.25, 0, 1, 0, 0, 0.0], np.float32),
            np.asarray([0.6, 0.05, 0.25, 0, 1, 0, 0, 0.0], np.float32),
        ]
    elif embodiment_type == EmbodimentType.HUMANOID:
        left = [-0.2236, 0.2580, 1.0964, 0.5039, 0.4955, -0.5064, 0.4941]
        right = [0.0605, 0.2517, 1.1063, 0.4773, 0.5318, -0.4857, 0.5034]
        up = np.asarray([0, 0, 0.2, 0, 0, 0, 0], np.float64)
        fwd_up = np.asarray([0.3, 0, 0.2, 0, 0, 0, 0], np.float64)
        goals = [
            np.concatenate([left, [1.0], right, [0.0], [-1.57]]).astype(
                np.float32
            ),
            np.concatenate(
                [np.add(left, up), [0.0], np.add(right, fwd_up), [1.0], [1.57]]
            ).astype(np.float32),
        ]
    else:
        raise ValueError(f"Invalid embodiment type: {embodiment_type}")
    return GoalPolicy(goal_states=goals)


class NvbloxDiffuserActorPolicy(PolicyBase):
    """Live mapping + diffusion policy on ``device`` (default ``cuda``;
    raises when CUDA is absent and no device is given). The model must
    already be there.

    ``num_inference_steps`` / ``scheduler_kind`` / ``stochastic_sampling`` /
    ``timestep_spacing`` / ``clip_sample`` select the sampler (defaults:
    upstream's stochastic DDPM at the training timestep count).
    ``num_prediction_samples`` > 1 samples K goals as one batch and fuses
    them with ``aggregate_trajectory_samples``. Noise comes from a
    ``torch.Generator`` seeded with ``seed`` on the device, and vertex
    sampling from a numpy generator of the same seed.
    """

    def __init__(
        self,
        model: DiffuserActor,
        embodiment: EmbodimentBase,
        mapping_config: MappingConfig,
        workspace_bounds,
        num_vertices_to_sample: int = 2048,
        vertex_sampling_method: VertexSamplingMethod = (
            VertexSamplingMethod.RANDOM_WITHOUT_REPLACEMENT),
        feature_fn=None,
        num_history: int = 3,
        seed: int = 0,
        include_dynamic: bool = False,
        num_inference_steps: Optional[int] = None,
        scheduler_kind: str = "ddpm",
        stochastic_sampling: bool = True,
        num_prediction_samples: int = 1,
        timestep_spacing: str = "leading",
        clip_sample: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        # "cuda" and "cuda:0" name one card: compare where tensors land.
        self.device = torch.empty(0, device=resolve_device(device)).device
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the policy on {self.device}")
        if num_prediction_samples < 1:
            raise ValueError(f"num_prediction_samples must be >= 1, got {num_prediction_samples}")
        self.model = model
        self.config = model.config
        self.embodiment = embodiment
        self.mapping_config = mapping_config
        self.bounds = np.asarray(workspace_bounds, dtype=np.float32)
        self.num_vertices_to_sample = num_vertices_to_sample
        self.vertex_sampling_method = vertex_sampling_method
        self.num_history = num_history
        self.include_dynamic = include_dynamic
        self.sampler = dict(
            num_inference_steps=num_inference_steps, scheduler_kind=scheduler_kind,
            stochastic=stochastic_sampling, timestep_spacing=timestep_spacing,
            clip_sample=clip_sample)
        self.num_prediction_samples = num_prediction_samples
        # Live surface-extraction budget; doubles whenever the scene has more
        # zero-crossings, up to MESH_BUDGET_CAP.
        self._mesh_budget = max(num_vertices_to_sample, 4096)
        # The dynamic map's feature pool is only allocated when needed.
        self.mapper = (
            Mapper.dual(mapping_config, self.device) if include_dynamic
            else Mapper({MapperId.STATIC: mapping_config}, self.device))
        self.history: collections.deque = collections.deque(maxlen=num_history)
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # Feature extractor for mapping: (H, W, 3) [0,1] -> (h, w, F).
        if feature_fn is None:
            feature_fn = make_feature_fn(
                "rgb", mapping_config.upscaled_feature_image_size, device=self.device)
        self.feature_fn = feature_fn
        # Fail loudly on a feature-dim mismatch: the model's vertex-feature
        # encoder must take the live map's feature width.
        trained_dim = None
        for name in ("reconstruction_encoder", "image_feature_encoder"):
            encoder = getattr(model.encoder, name, None)
            if encoder is not None:
                trained_dim = encoder.in_features
                break
        if trained_dim is not None and trained_dim != mapping_config.feature_dim:
            raise ValueError(
                f"checkpoint was trained on {trained_dim}-d vertex features but the "
                f"mapper is configured for {mapping_config.feature_dim}-d "
                "(feature_type mismatch between training data and the live mapping "
                "feature extractor - check --feature_type / --backbone_weights)")

    # --- per-sim-step map update ---------------------------------------------
    def step(self, env: EnvironmentBase) -> None:
        # The map is only updated when the model reads it; rgbd mode reads
        # the cameras at inference time.
        if self.config.data_type not in ("mesh", "rgbd_and_mesh"):
            return
        with span("policy/step"):
            self.mapper.decay()
            for frame in env.get_cameras().values():
                with span("policy/step/features"):
                    features = self.feature_fn(frame.rgb)
                with span("policy/step/robot_mask"):
                    dynamic_mask = dynamic_mask_from_segmentation(
                        frame.segmentation, env.semantic_id_to_class,
                        self.mapping_config.dynamic_class_labels)
                    if dynamic_mask is not None:
                        dynamic_mask = torch.as_tensor(dynamic_mask, device=self.device)
                with span("policy/step/integrate"):
                    nvblox_integrate(
                        self.mapper, self.mapping_config, frame.depth, features,
                        frame.intrinsics, pose7_to_matrix(frame.pose7), frame.rgb,
                        dynamic_mask=dynamic_mask, include_dynamic=self.include_dynamic)

    def _update_history(self, env: EnvironmentBase) -> None:
        """Record the policy state once per inference, not per sim step; the
        first inference seeds the whole history with the current state."""
        state = np.asarray(env.get_policy_state(), dtype=np.float32)
        if not self.history:
            self.history.extend([state] * self.num_history)
        else:
            self.history.append(state)

    # --- inference -----------------------------------------------------------
    def _extract_mesh_growing(self, mapper_id: int) -> None:
        """``update_feature_mesh`` with a budget that doubles until the
        crossing count fits (up to the cap): a fixed budget truncates big
        scenes by voxel linear index, dropping one side of the workspace."""
        self.mapper.update_feature_mesh(mapper_id, max_vertices=self._mesh_budget)
        while (self.mapper.last_crossing_count > self._mesh_budget
               and self._mesh_budget < MESH_BUDGET_CAP):
            self._mesh_budget = min(2 * self._mesh_budget, MESH_BUDGET_CAP)
            self.mapper.update_feature_mesh(mapper_id, max_vertices=self._mesh_budget)

    def mesh_vertices(self) -> Tuple[np.ndarray, np.ndarray]:
        """The live map's surface vertices and features (host arrays), the
        DYNAMIC map's after the STATIC one's with ``include_dynamic``."""
        with span("policy/goal/mesh"):
            self._extract_mesh_growing(MapperId.STATIC)
            vertices, features = get_vertices_and_features(
                self.mapper, MapperId.STATIC, remove_zero_features=True)
            if self.include_dynamic:
                # Training meshes hold static + dynamic combined; the manipulated
                # object lives in the DYNAMIC map.
                self._extract_mesh_growing(MapperId.DYNAMIC)
                dyn_v, dyn_f = get_vertices_and_features(
                    self.mapper, MapperId.DYNAMIC, remove_zero_features=True)
                vertices = np.concatenate([vertices, dyn_v], axis=0)
                features = np.concatenate([features, dyn_f], axis=0)
            return vertices, features

    def sample_vertices(self, vertices: np.ndarray, features: np.ndarray):
        """(vertices, features, valid) at exactly the vertex budget."""
        with span("policy/goal/sample_vertices"):
            return sample_to_n_vertices(vertices, features, self.num_vertices_to_sample,
                                        self.vertex_sampling_method, self._rng)

    def camera_inputs(self, env: EnvironmentBase) -> Dict[str, Any]:
        """RGB (host), world point clouds (on the device) and depth-valid
        masks (host) of every camera, each (1, ncam, H, W, ...)."""
        def on_device(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

        with span("policy/goal/camera_inputs"):
            rgbs, pcds, valids = [], [], []
            for frame in env.get_cameras().values():
                rgbs.append(frame.rgb)
                pose7 = np.asarray(frame.pose7)
                pcds.append(get_camera_pointcloud(on_device(frame.intrinsics),
                                                  on_device(frame.depth),
                                                  on_device(pose7[:3]), on_device(pose7[3:])))
                valids.append(np.asarray(frame.depth) > 0)
            rgbs = np.stack(rgbs)[None]
            if rgbs.dtype == np.float64:
                rgbs = rgbs.astype(np.float32)
            return {"rgbs": rgbs, "pcds": torch.stack(pcds)[None],
                    "pcd_valid_mask": np.stack(valids)[None]}

    def _model_inputs(self, env: EnvironmentBase) -> Dict[str, Any]:
        batch: Dict[str, Any] = dict.fromkeys((
            "gt_gripper_pred", "gt_head_yaw", "instruction", "rgbs", "pcds",
            "pcd_valid_mask", "vertices", "vertex_features", "vertices_valid_mask"))
        hist = np.stack(list(self.history)[-self.num_history:])[None]  # (1, nhist, P)
        batch["gripper_history"] = self.embodiment.split_gripper_tensor(hist)
        if self.config.data_type in ("mesh", "rgbd_and_mesh"):
            vertices, features, valid = self.sample_vertices(*self.mesh_vertices())
            batch["vertices"] = vertices[None].astype(np.float32)
            batch["vertex_features"] = features[None].astype(np.float32)
            batch["vertices_valid_mask"] = valid[None]
        if self.config.data_type in ("rgbd", "rgbd_and_mesh"):
            batch.update(self.camera_inputs(env))
        return batch

    def predict(self, batch: Dict[str, Any], init_noise: Optional[torch.Tensor] = None,
                step_noise: Optional[torch.Tensor] = None):
        """(trajectory (K, L, G, 8), head yaw (K, L, 1) or None) as host
        arrays for one model batch, tiled to the K prediction samples.

        Noise comes from the policy's generator unless the caller passes
        ``init_noise`` (K, L, G, 9) and, for stochastic sampling,
        ``step_noise`` (T, K, L, G, 9).
        """
        K = self.num_prediction_samples

        def tiled(x):
            if x is None:
                return None
            if isinstance(x, torch.Tensor):
                return x.expand((K,) + tuple(x.shape[1:])).contiguous()
            x = np.asarray(x)
            return np.array(np.broadcast_to(x, (K,) + x.shape[1:]))

        with span("policy/goal/predict"):
            prepared = prepare_inputs({k: tiled(v) for k, v in batch.items()}, self.bounds,
                                      self.config, device=self.device)
            traj, head_yaw, _ = sample_trajectory(
                self.model, prepared, self.bounds, init_noise=init_noise,
                step_noise=step_noise,
                generator=self._generator if init_noise is None else None, **self.sampler)
            return traj.cpu().numpy(), None if head_yaw is None else head_yaw.cpu().numpy()

    def get_new_goal(self, env: EnvironmentBase, init_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[torch.Tensor] = None) -> List[np.ndarray]:
        """The next goal(s); ``init_noise`` / ``step_noise`` as in ``predict``."""
        with span("policy/goal"):
            self._update_history(env)
            traj, head_yaw = self.predict(self._model_inputs(env), init_noise, step_noise)
            if self.num_prediction_samples > 1:
                traj, head_yaw = aggregate_trajectory_samples(traj, head_yaw)
            return trajectory_to_policy_states(traj, head_yaw, self.embodiment)


def aggregate_trajectory_samples(
    traj: np.ndarray, head_yaw: Optional[np.ndarray]
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Fuse K i.i.d. diffusion samples into one consensus trajectory.

    ``traj`` is (K, L, G, 8) = pos3 + quat4 + openness; ``head_yaw`` is
    (K, L, 1) or None. Returns ((1, L, G, 8), (1, L, 1) | None):

    - positions: per-coordinate median over K;
    - rotations: the quaternions of the medoid sample (closest to the median
      positions over the whole trajectory);
    - openness: the mean probability; head yaw: the median.
    """
    med_pos = np.median(traj[..., :3], axis=0)  # (L, G, 3)
    dists = np.linalg.norm(traj[..., :3] - med_pos[None], axis=-1)  # (K, L, G)
    medoid = int(np.argmin(dists.sum(axis=(1, 2))))
    out = traj[medoid].copy()  # (L, G, 8)
    out[..., :3] = med_pos
    out[..., 7] = traj[..., 7].mean(axis=0)
    out_yaw = None if head_yaw is None else np.median(head_yaw, axis=0)
    return out[None], (None if out_yaw is None else out_yaw[None])


def trajectory_to_policy_states(
    traj: np.ndarray, head_yaw: Optional[np.ndarray], embodiment: EmbodimentBase
) -> List[np.ndarray]:
    """(1, L, G, 8) model output [+ head yaw] -> list of policy-state vectors;
    openness is binarized at 0.5 (the policy commands binary grippers)."""
    goals = []
    for i in range(traj.shape[1]):
        step = traj[0, i].copy()  # (G, 8)
        step[..., 7] = (step[..., 7] >= 0.5).astype(step.dtype)
        if embodiment.embodiment_type == EmbodimentType.ARM:
            goals.append(step[0])
        else:
            hy = 0.0 if head_yaw is None else float(head_yaw[0, i, 0])
            goals.append(np.concatenate([step[0], step[1], [hy]]).astype(np.float32))
    return goals
