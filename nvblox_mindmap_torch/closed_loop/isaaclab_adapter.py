"""Isaac Lab sim-host adapter: ``EnvironmentBase`` over a live gym env.

Port of ``nvblox_mindmap_tpu/closed_loop/isaaclab_adapter.py``. It runs on
the simulator's host and serves the simulation to the policy through the
bridge (``closed_loop/remote_env.py``)::

    from nvblox_mindmap_torch.closed_loop.isaaclab_adapter import (
        make_isaaclab_environment)
    from nvblox_mindmap_torch.closed_loop.remote_env import serve_environment
    env = make_isaaclab_environment(task=Tasks.CUBE_STACKING,
                                    hdf5_file=..., demo_name="demo_0")
    serve_environment(env, port=5555)  # policy host: RemoteEnvironment(host, port)

The wire format is shared with the JAX package, so either package's policy
drives either package's server. A machine with both Isaac Lab and a card
could hold the adapter in the policy's own process, without the bridge;
that arrangement is not verified.

The adapter mirrors the reference's episode and step semantics (reference:
mindmap/closed_loop/closed_loop_policy.py:79-241):

- ``reset`` re-initializes the sim to the demo's recorded initial state
  (``env.unwrapped.reset_to(initial_state, is_relative=True)``, :109-111).
- ``step(goal)`` converts the goal policy state to the embodiment's action
  (arm: pose + +/-1 gripper command, reference arm/controller.py:22-36;
  humanoid: pose pair + retargeted hand joints + head yaw,
  humanoid/controller.py:50-88) and steps the sim with it as a CPU
  ``(1, n)`` tensor; ``step(None)`` holds the current pose (the reference's
  warmup, :123-134).
- ``get_cameras`` returns rgb / depth / intrinsics / pose7 and a flattened
  semantic-label image, from which the policy builds its dynamic mask
  (isaaclab_camera_handler.py:161-209).
- ``get_object_poses`` exposes rigid-object root poses for the task
  evaluators (cube_stacking_evaluator.py:306-324).
- ``is_success`` judges success with the task's mdp predicate
  (``task_outcome_fn``, as tasks/task_success.py:18-29); the termination
  manager is only a fallback for envs without the config surgery, since
  the surgery clears every termination term.

The class takes the gym env and camera handlers as arguments, so its
protocol is testable with stand-ins anywhere; only
``make_isaaclab_environment`` needs Isaac Lab, and off a sim host it raises
(there is no fallback).

Sim-host contract (what the factory needs):

1. **Task env registrations.** ``gym.make(TASK_TO_GYM_ID[task])`` resolves
   only if the gym ids (``Isaac-Stack-Cube-Franka-With-Cams-IK-Rel-v0``
   etc.) are registered: the reference's task package (``mindmap/tasks``,
   Isaac Lab manager-based env configs and mimic envs) or an equivalent
   registration module must be importable on the sim host. The repository
   does not vendor those configs (Isaac-Lab-bound scene, observation and
   termination definitions, with no behaviour on the policy's side).
2. **Policy cameras come from the task env configs**, not from this
   adapter: the env cfgs define the wrist / table (arm) and pov / external
   (humanoid) cameras as ``<name>_cam`` scene entries; the only camera the
   reference injects at env creation is the optional recording camera
   (reference isaaclab_utils/environments.py:84-106), as
   ``update_env_cfg_for_perceptive_il`` below can.
3. **Perceptive-IL config surgery.** The reference mutates the MimicGen env
   config before gym.make (environments.py:109-195): recorders and
   terminations cleared, absolute-mode arm controller corrections,
   stiffness / damping, render settings. ``update_env_cfg_for_perceptive_il``
   reproduces it on any attribute-compatible cfg (testable off the host).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.environment import (
    CameraFrame,
    EnvironmentBase,
)
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType

ARM_CLOSEDNESS_THRESHOLD = 0.5


def arm_action_from_policy_state(policy_state: np.ndarray) -> np.ndarray:
    """(8,) policy state -> (8,) sim action: pose + gripper command in
    {-1 close, +1 open} (reference arm/controller.py:22-36, action.py)."""
    state = np.asarray(policy_state, np.float32)
    assert state.shape == (8,)
    closedness = float(state[7])
    assert 0.0 <= closedness <= 1.0
    command = -1.0 if closedness > ARM_CLOSEDNESS_THRESHOLD else 1.0
    return np.concatenate([state[:7], [command]]).astype(np.float32)


def humanoid_action_from_policy_state(policy_state: np.ndarray) -> np.ndarray:
    """(17,) policy state -> (37,) sim action via hand retargeting."""
    from nvblox_mindmap_torch.embodiments.humanoid_hand import HumanoidController

    return HumanoidController()(policy_state).to_tensor(include_head_yaw=True)


def _to_numpy(x) -> np.ndarray:
    """A sim tensor (torch, on any device) or array as host numpy: the
    adapter reads the simulator's state, which lives in torch tensors."""
    if hasattr(x, "detach"):
        x = x.detach()
    if hasattr(x, "cpu"):
        x = x.cpu()
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(x)


def compare_states(
    state_from_dataset, runtime_state, action_index: int,
    tolerance: float = 0.1,
):
    """Replay-divergence check for sim-side datagen.

    Compares the recorded episode state against the live sim state per
    replayed action, element-by-element over the nested
    {asset_type: {asset_name: {state_name: values}}} layout
    (reference: isaaclab_utils/isaaclab_datagen_utils.py:40-72; called per
    action from run_isaaclab_datagen.py:246). A diverged replay marks the
    demo FAILED_DATAGEN rather than producing silently-wrong training data.

    Returns:
        (states_matched, log) - log details every mismatched element.
    """
    states_matched = True
    output_log = ""
    for asset_type in ("articulation", "rigid_object"):
        for asset_name in runtime_state.get(asset_type, {}):
            for state_name in runtime_state[asset_type][asset_name]:
                # reshape(-1), not squeeze(): a single-element state vector
                # must stay 1-d (len() of a squeezed 0-d array raises).
                runtime_vals = _to_numpy(
                    runtime_state[asset_type][asset_name][state_name]
                ).reshape(-1)
                dataset_vals = _to_numpy(
                    state_from_dataset[asset_type][asset_name][state_name]
                )[action_index].reshape(-1)
                if len(dataset_vals) != len(runtime_vals):
                    raise ValueError(
                        f"State shape of {state_name} for asset {asset_name} "
                        "don't match"
                    )
                for i in range(len(dataset_vals)):
                    if abs(float(dataset_vals[i]) - float(runtime_vals[i])) > tolerance:
                        states_matched = False
                        output_log += (
                            f'\tState ["{asset_type}"]["{asset_name}"]'
                            f'["{state_name}"][{i}] don\'t match\r\n'
                            f"\t  Dataset:\t{dataset_vals[i]}\r\n"
                            f"\t  Runtime: \t{runtime_vals[i]}\r\n"
                        )
    return states_matched, output_log


class IsaacLabEnvironment(EnvironmentBase):
    """EnvironmentBase over an Isaac Lab manager-based env.

    Args:
        env: the gym env (Isaac Lab; any object with the used surface works).
        embodiment: the policy's embodiment (codecs only).
        camera_handlers: name -> camera-handler objects exposing the
            reference IsaacLabCameraHandler getters (get_rgb/get_depth/
            get_intrinsics/get_pose/get_semantic_segmentation).
        robot_state_fn: env -> robot-state vector (the sim-specific read;
            reference: embodiment.get_robot_state(env)).
        initial_state: recorded HDF5 initial state for reset_to (optional).
        success_fn: env -> bool success term (optional; defaults to the
            env's termination manager 'success' term when present).
        object_names: rigid objects to expose to the task evaluators.
    """

    def __init__(
        self,
        env,
        embodiment: EmbodimentBase,
        camera_handlers: Dict[str, object],
        robot_state_fn,
        initial_state=None,
        success_fn=None,
        object_names: Optional[List[str]] = None,
    ):
        self.env = env
        self.embodiment = embodiment
        self.camera_handlers = camera_handlers
        self.robot_state_fn = robot_state_fn
        self.initial_state = initial_state
        self.success_fn = success_fn
        self.object_names = list(object_names or [])
        self._label_map: Dict[int, str] = {}
        self._rgba_to_id: Dict[tuple, int] = {}

    # --- EnvironmentBase ------------------------------------------------------
    def reset(self) -> None:
        if self.initial_state is not None:
            self.env.unwrapped.reset_to(self.initial_state, None,
                                        is_relative=True)
        else:
            self.env.reset()

    def step(self, goal_policy_state: Optional[np.ndarray]) -> None:
        if goal_policy_state is None:
            # Warmup/hold: command the current pose (reference :123-134).
            goal_policy_state = self.get_policy_state()
        goal = np.asarray(goal_policy_state, np.float32)
        if self.embodiment.embodiment_type == EmbodimentType.ARM:
            action = arm_action_from_policy_state(goal)
        else:
            action = humanoid_action_from_policy_state(goal)
        self.env.step(self._batch_action(action))

    def _batch_action(self, action: np.ndarray):
        """The action as the env takes it: a CPU ``(1, n)`` tensor (the
        reference's ``unsqueeze(0)``)."""
        import torch

        return torch.from_numpy(np.asarray(action)).unsqueeze(0)

    def get_robot_state(self) -> np.ndarray:
        return _to_numpy(self.robot_state_fn(self.env)).astype(np.float32)

    def get_policy_state(self) -> np.ndarray:
        robot_state = self.get_robot_state()
        return self.embodiment.policy_states_from_robot_states(
            robot_state[None], use_keyposes=False
        )[0]

    def get_cameras(self) -> Dict[str, CameraFrame]:
        frames = {}
        for name, cam in self.camera_handlers.items():
            rgb = _to_numpy(cam.get_rgb()).astype(np.float32)
            if rgb.max(initial=0.0) > 1.5:  # uint8-scaled
                rgb = rgb / 255.0
            depth = _to_numpy(cam.get_depth()).astype(np.float32)
            intr = _to_numpy(cam.get_intrinsics()).astype(np.float32)
            translation, rotation_quat = cam.get_pose()
            pose7 = np.concatenate(
                [_to_numpy(translation).reshape(3),
                 _to_numpy(rotation_quat).reshape(4)]
            ).astype(np.float32)
            seg = self._flatten_segmentation(cam)
            frames[name] = CameraFrame(rgb, depth, intr, pose7, seg)
        return frames

    def _flatten_segmentation(self, cam) -> Optional[np.ndarray]:
        """RGBA-id segmentation -> integer label image + id->class map.

        Isaac Lab encodes instance ids as RGBA colors with a per-frame
        rgba -> {'class': name} map (reference camera handler :161-175); the
        recorded boundary and the remote protocol use integer labels, so
        RGBA tuples are interned into stable small ints here.
        """
        if not hasattr(cam, "get_semantic_segmentation"):
            return None
        try:
            seg_rgba, rgba_to_labels = cam.get_semantic_segmentation()
        except Exception:
            return None
        seg_rgba = _to_numpy(seg_rgba)
        out = np.zeros(seg_rgba.shape[:2], dtype=np.uint16)
        import ast

        for rgba_key, label in rgba_to_labels.items():
            rgba = tuple(
                ast.literal_eval(rgba_key) if isinstance(rgba_key, str)
                else rgba_key
            )
            class_name = (label.get("class", "") if isinstance(label, dict)
                          else str(label))
            if rgba not in self._rgba_to_id:
                new_id = len(self._rgba_to_id) + 1
                self._rgba_to_id[rgba] = new_id
                self._label_map[new_id] = class_name
            match = np.all(
                seg_rgba == np.asarray(rgba, seg_rgba.dtype).reshape(1, 1, -1),
                axis=-1,
            )
            out[match] = self._rgba_to_id[rgba]
        return out

    @property
    def semantic_id_to_class(self) -> Dict[int, str]:
        return dict(self._label_map)

    def get_object_poses(self) -> Dict[str, np.ndarray]:
        scene_state = self.env.unwrapped.scene.get_state(is_relative=True)
        rigid = scene_state.get("rigid_object", {})
        poses = {}
        for name in (self.object_names or rigid.keys()):
            if name in rigid:
                poses[name] = _to_numpy(rigid[name]["root_pose"][0, :7])
        return poses

    def is_success(self) -> bool:
        if self.success_fn is not None:
            return bool(self.success_fn(self.env))
        try:
            term = self.env.unwrapped.termination_manager.get_term("success")
            return bool(_to_numpy(term).reshape(-1)[0])
        except Exception:
            # The perceptive-IL surgery clears env_cfg.terminations, so on a
            # surgered env this fallback can NEVER find a 'success' term;
            # success must come from success_fn (task_outcome_fn below,
            # mirroring reference tasks/task_success.py:18-29). Warn once
            # instead of silently reporting 0/N success forever.
            if not getattr(self, "_warned_no_success_term", False):
                self._warned_no_success_term = True
                import logging

                logging.getLogger(__name__).warning(
                    "is_success: no success_fn and no 'success' termination "
                    "term (the perceptive-IL cfg surgery clears terminations)"
                    " - reporting False. Pass success_fn=task_outcome_fn(task)"
                    " for task-semantics success."
                )
            return False


def task_outcome_fn(task):
    """env -> bool task-success predicate, mirroring the reference's
    ``get_task_outcome`` (tasks/task_success.py:18-29): success is judged by
    calling the task's mdp predicate on the live env directly, NOT via the
    termination manager (which the perceptive-IL surgery clears).

    Deferred imports: the mdp modules live in the sim-host task package
    (isaaclab_tasks + the reference's ``mindmap.tasks``); raises ImportError
    with the sim-host-contract instruction when they are absent.
    """
    from nvblox_mindmap_torch.embodiments.registry import Tasks

    task = Tasks(task)
    try:
        if task == Tasks.CUBE_STACKING:
            from isaaclab_tasks.manager_based.manipulation.stack import (
                mdp as mdp_mod,
            )

            return lambda env: bool(_to_numpy(
                mdp_mod.cubes_stacked(env)).reshape(-1)[0])
        if task == Tasks.MUG_IN_DRAWER:
            from mindmap.tasks.task_definitions.mug_in_drawer import (
                mdp as mdp_mod,
            )

            return lambda env: bool(_to_numpy(
                mdp_mod.object_in_drawer(env)).reshape(-1)[0])
        if task == Tasks.DRILL_IN_BOX:
            from mindmap.tasks.task_definitions.drill_in_box.config.gr1 import (
                mdp as mdp_mod,
            )

            # check_hand_height=False: mindmap does not distinguish the
            # left/right drill_in_box variants (reference task_success.py:24).
            return lambda env: bool(_to_numpy(mdp_mod.object_in_box(
                env, check_hand_height=False)).reshape(-1)[0])
        if task == Tasks.STICK_IN_BIN:
            from mindmap.tasks.task_definitions.stick_in_bin.config.gr1 import (
                mdp as mdp_mod,
            )

            return lambda env: bool(_to_numpy(mdp_mod.object_in_drum(
                env, check_hand_height=False)).reshape(-1)[0])
    except ImportError as e:
        raise ImportError(
            f"task_outcome_fn({task}): the task mdp module is sim-host-side "
            "(isaaclab_tasks / the reference 'mindmap' task package) and is "
            "not installed - see the module docstring's sim-host contract."
        ) from e
    raise ValueError(f"No outcome check for task {task}.")


def update_env_cfg_for_perceptive_il(
    env_cfg,
    embodiment_type: EmbodimentType,
    absolute_mode: bool = True,
    render_settings: str = "default",
    record_camera_params: Optional[Dict] = None,
):
    """MimicGen env cfg -> Perceptive-IL env cfg, duck-typed.

    Reproduces the reference's pre-gym.make config surgery
    (isaaclab_utils/environments.py:84-195) on any attribute-compatible cfg
    object, so the transformation is unit-testable off the sim host:

    - recorders/terminations cleared (:109-110),
    - arm absolute mode: non-relative IK, scale 1.0, the 0.1034 m
      control-frame z-offset correction (asserted equal to the measured
      ee_frame offset), shoulder/forearm stiffness 400->2000 and damping
      80->240 (:153-174),
    - viewer eye moved to (1.5, 1.5, 1.5) (:181),
    - render settings: 'deterministic' disables antialiasing, 'high_quality'
      switches to PathTracing (:184-192),
    - optional 1200x1200 recording camera injected as scene.record_cam
      (:84-102); policy cameras are NOT injected - they come from the task
      package's env configs.
    """
    env_cfg.recorders = {}
    env_cfg.terminations = {}
    if embodiment_type == EmbodimentType.ARM:
        if absolute_mode:
            arm_action = env_cfg.actions.arm_action
            arm_action.controller.use_relative_mode = False
            arm_action.scale = 1.0
            # Control-frame offset correction; the reference keeps the bug in
            # relative mode because MimicGen data was recorded with it.
            arm_action.body_offset.pos = [0.0, 0.0, 0.1034]
            eef_frame = env_cfg.scene.ee_frame.target_frames[0]
            assert list(eef_frame.offset.pos) == list(arm_action.body_offset.pos), (
                "eef control and measurement frame should have the same offset."
            )
            for group in ("panda_shoulder", "panda_forearm"):
                env_cfg.scene.robot.actuators[group].stiffness = 2000.0
                env_cfg.scene.robot.actuators[group].damping = 240.0
    elif embodiment_type == EmbodimentType.HUMANOID:
        pass
    else:
        raise ValueError(f"Invalid embodiment type: {embodiment_type}")
    env_cfg.viewer.eye = (1.5, 1.5, 1.5)
    if render_settings == "deterministic":
        env_cfg.sim.render.antialiasing_mode = "Off"
    elif render_settings == "high_quality":
        env_cfg.sim.render.carb_settings = {"rtx.rendermode": "PathTracing"}
    elif render_settings != "default":
        raise ValueError(f"Invalid render settings: {render_settings}")
    if record_camera_params is not None:
        # Deferred import: CameraCfg exists only on the sim host.
        import isaaclab.sim as sim_utils
        from isaaclab.sensors import CameraCfg

        env_cfg.scene.record_cam = CameraCfg(
            prim_path="{ENV_REGEX_NS}/record_cam",
            update_period=0.0333,
            height=1200,
            width=1200,
            data_types=["rgb", "distance_to_image_plane"],
            spawn=sim_utils.PinholeCameraCfg(
                focal_length=record_camera_params["focal_length"],
                focus_distance=400.0,
                horizontal_aperture=20.955,
                clipping_range=(0.1, 1.0e5),
            ),
            offset=CameraCfg.OffsetCfg(
                pos=record_camera_params["position"],
                rot=record_camera_params["rotation"],
                convention="opengl",
            ),
        )
    return env_cfg


def make_isaaclab_environment(
    task,
    hdf5_file: str,
    demo_name: str,
    headless: bool = True,
    add_external_cam: bool = False,
    absolute_mode: bool = True,
    render_settings: str = "default",
):
    """Build the full sim-host environment (requires Isaac Lab).

    Mirrors the reference app startup (run_closed_loop_policy.py:53-114):
    SimulationAppContext -> env cfg parse + perceptive-IL surgery -> gym env
    -> camera handlers -> HDF5 initial state. Import-guarded: raises a clear
    error off the sim host.

    PREREQUISITE: the gym ids in TASK_TO_GYM_ID must already be registered
    (install the reference's ``mindmap`` task package, or equivalent env
    registrations, on the sim host - see the module docstring's sim-host
    contract). A missing registration raises with that instruction rather
    than gymnasium's bare NameNotFound.
    """
    try:
        from isaaclab.app import AppLauncher  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "make_isaaclab_environment needs Isaac Lab (sim host only). "
            "On the policy's host, connect with RemoteEnvironment instead."
        ) from e

    # Deferred: these imports exist only on the sim host.
    import gymnasium as gym
    from isaaclab.app import AppLauncher

    app = AppLauncher({"headless": headless}).app  # noqa: F841

    from nvblox_mindmap_torch.embodiments.registry import (
        TASK_TO_GYM_ID,
        Tasks,
        make_embodiment_for_task,
    )

    task = Tasks(task)
    embodiment = make_embodiment_for_task(task)
    gym_id = TASK_TO_GYM_ID[task]
    if gym_id not in gym.registry:
        raise RuntimeError(
            f"gym id {gym_id!r} is not registered: the task env configs are "
            "sim-host-side and not vendored by this framework. Install the "
            "reference 'mindmap' package (its tasks/ module registers the "
            "four benchmark envs) or equivalent registrations with matching "
            "ids, <name>_cam scene cameras, and importable task mdp success "
            "predicates (see task_outcome_fn)."
        )
    # Only the parse_cfg import is allowed to fall back (older Isaac Lab
    # layouts); an ImportError raised later - e.g. lazily inside gym.make -
    # must propagate, not silently produce an un-surgeried MimicGen env
    # (active recorders/terminations + relative-mode IK against absolute
    # policy goals).
    try:
        from isaaclab_tasks.utils.parse_cfg import parse_env_cfg
    except ImportError:
        parse_env_cfg = None
    if parse_env_cfg is not None:
        env_cfg = parse_env_cfg(gym_id, num_envs=1)
        env_cfg = update_env_cfg_for_perceptive_il(
            env_cfg, embodiment.embodiment_type,
            absolute_mode=absolute_mode, render_settings=render_settings,
        )
        env = gym.make(gym_id, cfg=env_cfg)
    else:
        import warnings

        warnings.warn(
            "isaaclab_tasks.utils.parse_cfg unavailable: building the env "
            "with its registered default cfg, WITHOUT the perceptive-IL "
            "surgery (recorders/terminations stay active; arm controller "
            "stays in the recorded MimicGen mode)."
        )
        env = gym.make(gym_id)

    # Camera handlers, reference-style (isaaclab_camera_handler.py).
    camera_names = (
        ["wrist", "table"] if embodiment.embodiment_type == EmbodimentType.ARM
        else ["pov"] + (["external"] if add_external_cam else [])
    )
    camera_handlers = {
        name: _ReferenceStyleCameraHandler(env, name) for name in camera_names
    }

    import h5py

    with h5py.File(hdf5_file, "r") as f:
        initial_state = f["data"][demo_name]["initial_state"][()]

    # Success via the task's mdp predicate (reference task_success.py:18-29):
    # the surgery above cleared the termination manager, so the env's own
    # 'success' term no longer exists.
    try:
        success_fn = task_outcome_fn(task)
    except ImportError as e:
        import warnings

        warnings.warn(
            f"task mdp predicates unavailable ({e}); is_success will fall "
            "back to the (cleared) termination manager and report False."
        )
        success_fn = None

    return IsaacLabEnvironment(
        env, embodiment, camera_handlers,
        robot_state_fn=_default_arm_robot_state_fn
        if embodiment.embodiment_type == EmbodimentType.ARM
        else _default_humanoid_robot_state_fn,
        initial_state=initial_state,
        success_fn=success_fn,
    )


def _default_arm_robot_state_fn(env) -> np.ndarray:
    """Franka robot state (9,): eef pose from the ee_frame sensor + the two
    gripper jaw joint positions (reference arm/robot_state.py semantics)."""
    scene = env.unwrapped.scene
    ee = scene["ee_frame"]
    pos = _to_numpy(ee.data.target_pos_w[0, 0])
    quat = _to_numpy(ee.data.target_quat_w[0, 0])
    joints = _to_numpy(scene["robot"].data.joint_pos[0])
    jaws = joints[-2:]  # panda finger joints are the last two
    return np.concatenate([pos, quat, jaws]).astype(np.float32)


def _default_humanoid_robot_state_fn(env) -> np.ndarray:
    """GR1T2 robot state (37,): both eef poses + 11 hand joints each + head
    yaw, in the layout of embodiments/humanoid.py."""
    from nvblox_mindmap_torch.embodiments.humanoid_hand import (
        HumanoidJointIndices,
    )

    scene = env.unwrapped.scene
    left = scene["left_ee_frame"]
    right = scene["right_ee_frame"]
    joints = _to_numpy(scene["robot"].data.joint_pos[0])
    hands = joints[-2 * HumanoidJointIndices.num_joints_per_hand:]
    left_hand = hands[
        HumanoidJointIndices.left_joints_in_combined_hands_tensor_indices
    ]
    right_hand = hands[
        HumanoidJointIndices.right_joints_in_combined_hands_tensor_indices
    ]
    head_yaw = _to_numpy(scene["robot"].data.joint_pos[0, :1])  # task-defined
    return np.concatenate(
        [
            _to_numpy(left.data.target_pos_w[0, 0]),
            _to_numpy(left.data.target_quat_w[0, 0]),
            left_hand,
            _to_numpy(right.data.target_pos_w[0, 0]),
            _to_numpy(right.data.target_quat_w[0, 0]),
            right_hand,
            head_yaw.reshape(1),
        ]
    ).astype(np.float32)


class _ReferenceStyleCameraHandler:
    """Minimal camera handler over an Isaac Lab scene camera (sim host)."""

    def __init__(self, env, camera_name: str):
        self._camera = env.unwrapped.scene[f"{camera_name}_cam"]
        self.camera_name = camera_name

    def _output(self):
        return self._camera.data.output

    def get_rgb(self):
        return self._output()["rgb"][0]

    def get_depth(self):
        return self._output()["distance_to_image_plane"][0].squeeze(-1)

    def get_intrinsics(self):
        return self._camera.data.intrinsic_matrices[0]

    def get_pose(self):
        return (
            self._camera.data.pos_w[0],
            self._camera.data.quat_w_ros[0],
        )

    def get_semantic_segmentation(self):
        seg = self._output()["semantic_segmentation"][0]
        id_to_labels = self._camera.data.info[0]["semantic_segmentation"][
            "idToLabels"
        ]
        return seg, id_to_labels
