"""Scripted experts, demo recorders and demo-set generators for the scene world.

The port's own copy of ``nvblox_mindmap_tpu/closed_loop/scripted.py``.
Upstream generates its demonstrations with Isaac Lab Mimic experts and
records them through ``IsaacLabWriter`` (``mindmap/run_isaaclab_datagen.py``,
``mindmap/isaaclab_utils/isaaclab_writer.py``). Here deterministic
pick-and-place experts act in ``SceneKinematicEnvironment`` for all four
tasks, and every sim step is written in the recorded demo layout (RGB /
depth / semantic PNGs, pose and intrinsics, robot states whose jaws or hand
joints ramp, so the keypose machinery's grasp-event detection sees the
signal shape of real grippers), with a ``scene.json`` from which
``env_from_scene_json`` rebuilds the world, the JAX package's files
included.

- ``generate_{cube_stacking,mug_in_drawer,drill_in_box,stick_in_bin}_demos``
  write expert-verified demo sets (each scene seeded ``seed + index``);
- ``generate_cube_stacking_recovery_demos`` adds a mid-transport slip and
  the expert's recovery;
- ``generate_cube_stacking_dagger_demos`` lets a policy drive and the
  expert take over (HG-DAgger).

The produced demos feed the port's chain unchanged: ``run_datagen`` fusion
-> ``run_training`` -> open- and closed-loop evaluation.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from nvblox_mindmap_torch.closed_loop.evaluators import (
    CubeStackingEvaluator,
    DrillInBoxEvaluator,
    MugInDrawerEvaluator,
    StickInBinEvaluator,
)
from nvblox_mindmap_torch.closed_loop.goals import add_intermediate_goals, is_goal_reached
from nvblox_mindmap_torch.closed_loop.scene import SceneKinematicEnvironment, look_at_pose7
from nvblox_mindmap_torch.data.dataset import DemoDataset
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.data.writer import DemoWriter
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.embodiments.humanoid import (
    NUM_HAND_JOINTS,
    PROXIMAL_JOINT_INDICES,
    HumanoidEmbodiment,
)

# Jaw positions for the recorded 9-dim arm robot state: fully open matches
# the embodiment's GRIPPER_OPEN_THRESHOLD; the ramp speed (7.5 mm/frame)
# clears the grasp-event speed threshold (arm.py gripper_speed_threshold).
JAW_OPEN = 0.04
JAW_CLOSED = 0.01
JAW_SPEED = 0.0075

# Humanoid hand proximal-joint positions for the 37-dim robot state: the ramp
# crosses the hysteresis thresholds (embodiments/humanoid.py CLOSED/-0.4,
# OPEN/-0.2) and its 0.1 rad/frame speed clears the velocity-backtracking
# threshold (0.01), so grasp intervals resolve exactly like real GR1 jaws.
HAND_JOINT_OPEN = 0.0
HAND_JOINT_CLOSED = -0.7
HAND_JOINT_SPEED = 0.1

DOWN_QUAT = np.asarray([0.0, 1.0, 0.0, 0.0], dtype=np.float32)  # eef pointing down


def _goal(pos, closed: float) -> np.ndarray:
    return np.concatenate(
        [np.asarray(pos, np.float32), DOWN_QUAT, [np.float32(closed)]]
    )


def scripted_stack_goals(
    objects: Dict[str, np.ndarray],
    cube_half: float,
    hover_z: float = 0.22,
    retreat_pos=(0.4, 0.0, 0.3),
    approach_from=None,
) -> List[np.ndarray]:
    """Expert goal sequence stacking cube_2 (and cube_3, ...) onto cube_1.

    Mirrors the Mimic expert's phase structure (approach / descend / grasp /
    lift / transport / place / release / retreat) as 8-dim arm policy states.

    ``approach_from``: optional FIXED staging position replacing the
    above-the-pick approach. With it, the first object-dependent keypose is
    the pick itself - so a policy's gripper HISTORY carries no information
    about where the object is, and predicting the pick requires reading the
    observation (the control needed by the spatial-memory experiment).
    """
    names = sorted(objects)
    assert names[0] == "cube_1", f"expected cube_1..cube_N, got {names}"
    base = np.asarray(objects["cube_1"][:3], np.float64)
    goals: List[np.ndarray] = []
    for level, name in enumerate(names[1:], start=1):
        pick = np.asarray(objects[name][:3], np.float64)
        place = base + np.asarray([0.0, 0.0, 2.0 * cube_half * level])
        if approach_from is None:
            approach = _goal([pick[0], pick[1], hover_z], 0.0)
        else:
            approach = _goal(approach_from, 0.0)
        goals += [
            approach,                                  # approach / staging
            _goal(pick, 0.0),                          # descend
            _goal(pick, 1.0),                          # grasp
            _goal([pick[0], pick[1], hover_z], 1.0),   # lift
            _goal([place[0], place[1], hover_z], 1.0),  # transport
            _goal(place, 1.0),                          # place
            _goal(place, 0.0),                          # release
            _goal([place[0], place[1], hover_z], 0.0),  # retreat up
        ]
    goals.append(_goal(retreat_pos, 0.0))
    return goals


class ArmDemoRecorder:
    """Streams SceneKinematicEnvironment frames into the demo layout.

    Writes per frame: wrist_{rgb,depth,semantic}.png + wrist_{pose,
    intrinsics}.npy + robot_state.npy (9-dim: pose7 + 2 jaws). Jaws ramp
    toward the commanded closedness at JAW_SPEED so grasp events are
    detectable intervals, as real gripper recordings are.
    """

    def __init__(self, demo_dir: str, env: SceneKinematicEnvironment):
        self.writer = DemoWriter(demo_dir)
        self.env = env
        self.t = 0
        self._jaw = JAW_OPEN
        self.writer.write_semantic_labels(env.semantic_id_to_class)

    @property
    def jaws_settled(self) -> bool:
        target = JAW_CLOSED if float(self.env.state[7]) >= 0.5 else JAW_OPEN
        return abs(self._jaw - target) < 1e-6

    def record_frame(self) -> None:
        target = JAW_CLOSED if float(self.env.state[7]) >= 0.5 else JAW_OPEN
        self._jaw += np.clip(target - self._jaw, -JAW_SPEED, JAW_SPEED)
        state9 = np.concatenate(
            [self.env.state[:7], [self._jaw, self._jaw]]
        ).astype(np.float32)
        self.writer.write_robot_state(self.t, state9)
        for name, frame in self.env.get_cameras().items():
            self.writer.write_camera_frame(
                self.t, name, frame.rgb, frame.depth, frame.pose7,
                frame.intrinsics,
            )
            if frame.segmentation is not None:
                self.writer.write_semantic(self.t, name, frame.segmentation)
        self.t += 1


class HumanoidDemoRecorder:
    """Streams humanoid SceneKinematicEnvironment frames into the demo layout.

    Writes per frame: pov/external {rgb,depth,semantic}.png + {pose,
    intrinsics}.npy + robot_state.npy (37-dim: L pose7 + 11 hand joints,
    R likewise, head yaw). Hand proximal joints ramp toward the commanded
    closedness at HAND_JOINT_SPEED, so the hysteresis closedness and
    velocity-backtracked grasp intervals of the humanoid keypose estimator
    (embodiments/humanoid.py, reference humanoid/keypose_estimation.py)
    see the same signal shape as real GR1 hand recordings.
    """

    def __init__(self, demo_dir: str, env: SceneKinematicEnvironment):
        self.writer = DemoWriter(demo_dir)
        self.env = env
        self.t = 0
        self._joint = [HAND_JOINT_OPEN, HAND_JOINT_OPEN]  # left, right
        self.writer.write_semantic_labels(env.semantic_id_to_class)

    def _target(self, hand: int) -> float:
        closed_idx = 7 if hand == 0 else 15
        return (
            HAND_JOINT_CLOSED
            if float(self.env.state[closed_idx]) >= 0.5
            else HAND_JOINT_OPEN
        )

    @property
    def jaws_settled(self) -> bool:
        return all(
            abs(self._joint[h] - self._target(h)) < 1e-6 for h in (0, 1)
        )

    def record_frame(self) -> None:
        hands = []
        for h in (0, 1):
            self._joint[h] += float(
                np.clip(
                    self._target(h) - self._joint[h],
                    -HAND_JOINT_SPEED,
                    HAND_JOINT_SPEED,
                )
            )
            joints = np.zeros(NUM_HAND_JOINTS, dtype=np.float32)
            joints[PROXIMAL_JOINT_INDICES] = self._joint[h]
            hands.append(joints)
        state37 = np.concatenate(
            [
                self.env.state[0:7], hands[0],
                self.env.state[8:15], hands[1],
                self.env.state[16:17],
            ]
        ).astype(np.float32)
        self.writer.write_robot_state(self.t, state37)
        for name, frame in self.env.get_cameras().items():
            self.writer.write_camera_frame(
                self.t, name, frame.rgb, frame.depth, frame.pose7,
                frame.intrinsics,
            )
            if frame.segmentation is not None:
                self.writer.write_semantic(self.t, name, frame.segmentation)
        self.t += 1


def make_recorder(demo_dir: str, env: SceneKinematicEnvironment):
    if isinstance(env.embodiment, ArmEmbodiment):
        return ArmDemoRecorder(demo_dir, env)
    return HumanoidDemoRecorder(demo_dir, env)


def record_scripted_demo(
    demo_dir: str,
    env: SceneKinematicEnvironment,
    goals: List[np.ndarray],
    max_steps_per_goal: int = 40,
    settle_frames: int = 2,
) -> int:
    """Run the scripted goals in ``env``, recording every frame.

    Returns the number of recorded frames. Writes demo_successful.npy = 1
    (the expert is deterministic; callers may assert task success separately
    with an evaluator on the same env before recording).
    """
    env.reset()
    rec = make_recorder(demo_dir, env)
    rec.record_frame()  # initial observation
    _run_goals(rec, env, goals, max_steps_per_goal, settle_frames)
    rec.writer.write_outcome(1)
    return rec.t


def _run_goals(rec, env, goals, max_steps_per_goal=40, settle_frames=2):
    """Step+record ``goals`` against an already-reset env with an open
    recorder (the body of record_scripted_demo, reusable mid-episode)."""
    embodiment = env.embodiment
    for goal in goals:
        for _ in range(max_steps_per_goal):
            env.step(goal)
            rec.record_frame()
            if (
                is_goal_reached(embodiment, env.get_policy_state(), goal)
                and rec.jaws_settled
            ):
                break
        for _ in range(settle_frames):
            env.step(goal)
            rec.record_frame()


def write_scene_json(demo_dir: str, env: SceneKinematicEnvironment) -> None:
    """Persist the scene spec next to the demo so closed-loop evaluation can
    reconstruct the same world (the sim-side analog: Isaac episodes re-spawn
    the task scene from the env config + recorded reset state)."""
    spec = {
        "objects": {k: [float(x) for x in v[:3]]
                    for k, v in env.initial_objects.items()},
        # Per-object half extents (mixed-size scenes); older scene.json
        # files carry a single float, which the loader still accepts.
        "object_half_extents": {
            k: [float(x) for x in v]
            for k, v in env.object_half_map.items()
        },
        "fixed_objects": sorted(env.fixed_objects),
        "object_colors": {
            k: [float(x) for x in v] for k, v in env.object_colors.items()
        },
        "image_size": env.image_size,
        "grasp_radius_m": env.grasp_radius_m,
        "initial_state": [float(x) for x in env.initial_state],
        "embodiment": (
            "humanoid" if env._is_humanoid else "arm"
        ),
        "table_center": [float(x) for x in env.table.center],
        "table_half_extents": [float(x) for x in env.table.half_extents],
        "robot_class_name": env.robot_class_name,
        "head_position": [float(x) for x in env.head_position],
        "head_base_yaw": env.head_base_yaw,
        "head_look_distance_m": env.head_look_distance_m,
        "head_look_z_m": env.head_look_z_m,
        "max_head_yaw_step_rad": env.max_head_yaw_step_rad,
    }
    if env._is_humanoid and getattr(env, "_custom_camera_fn", False):
        # A factory-installed humanoid rig cannot be captured post-hoc:
        # sampling env.camera_pose_fn(t) now would evaluate any
        # state-dependent pose (e.g. a pov that tracks head yaw) at the
        # FINAL state for every t, and replay would silently fall back to
        # the default rig - a train/eval observation mismatch. Refuse
        # loudly; record per-step poses into a step-pure schedule if a
        # custom humanoid rig is ever needed.
        raise ValueError(
            "write_scene_json cannot serialize a custom humanoid camera"
            " rig (camera_pose_fn_factory): closed-loop replay would"
            " rebuild the default head rig and silently render different"
            " observations than the recording"
        )
    if not env._is_humanoid:
        # Serialize the (step-only) camera schedule so closed-loop replay
        # renders what the recording rendered - e.g. a panning camera that
        # looks away from the objects (the spatial-memory scenario). The
        # humanoid pov rig is state-dependent (follows head yaw) and is
        # already reconstructed from the head-rig keys above.
        n = max(env.steps + 1, 1)
        schedule: Dict[str, List[List[float]]] = {}
        for t in range(n):
            for name, pose in env.camera_pose_fn(t).items():
                schedule.setdefault(name, []).append(
                    [float(x) for x in pose]
                )
        # Drop the constant tail: replay holds the last recorded pose.
        for name, poses in schedule.items():
            while len(poses) > 1 and poses[-1] == poses[-2]:
                poses.pop()
        spec["camera_schedule"] = schedule
    with open(os.path.join(demo_dir, "scene.json"), "w") as f:
        json.dump(spec, f, indent=2)


def env_from_scene_json(demo_dir: str) -> Optional[SceneKinematicEnvironment]:
    """Rebuild the SceneKinematicEnvironment recorded with a demo, or None."""
    path = os.path.join(demo_dir, "scene.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        spec = json.load(f)
    half = spec["object_half_extents"]
    if isinstance(half, dict):
        half = {k: np.asarray(v) for k, v in half.items()}
    if spec.get("embodiment", "arm") == "humanoid":
        embodiment = HumanoidEmbodiment()
    else:
        embodiment = ArmEmbodiment()
    # Older scene.json files predate the table/head-rig keys; fall back to
    # the ctor defaults they were recorded with.
    extra = {}
    for key in (
        "table_center", "table_half_extents", "robot_class_name",
        "head_position", "head_base_yaw", "head_look_distance_m",
        "head_look_z_m", "max_head_yaw_step_rad",
    ):
        if key in spec:
            extra[key] = spec[key]
    camera_pose_fn = None
    if "camera_schedule" in spec:
        schedule = {
            name: [np.asarray(p, np.float32) for p in poses]
            for name, poses in spec["camera_schedule"].items()
        }

        def camera_pose_fn(step: int) -> Dict[str, np.ndarray]:
            return {
                name: poses[min(step, len(poses) - 1)]
                for name, poses in schedule.items()
            }

    return SceneKinematicEnvironment(
        embodiment,
        np.asarray(spec["initial_state"], np.float32),
        objects={k: np.asarray(v) for k, v in spec["objects"].items()},
        object_half_extents=half,
        image_size=int(spec["image_size"]),
        grasp_radius_m=spec["grasp_radius_m"],
        fixed_objects=spec.get("fixed_objects"),
        object_colors={
            k: np.asarray(v)
            for k, v in spec.get("object_colors", {}).items()
        },
        camera_pose_fn=camera_pose_fn,
        **extra,
    )


def make_cube_stacking_env(
    seed: int,
    num_cubes: int = 2,
    cube_half: float = 0.04,
    image_size: int = 64,
    camera_pose_fn: Optional[Callable[[int], Dict[str, np.ndarray]]] = None,
    randomize: bool = True,
    grasp_radius_m: float = 0.06,
    fixed_positions: Optional[Dict[str, np.ndarray]] = None,
) -> SceneKinematicEnvironment:
    """Cube-stacking scene with per-seed randomized cube placements.

    Cubes rest on the table (top z = 0) inside the cube_stacking task AABB
    (mapping/constants.py): x in [0.3, 0.7], y in [-0.25, 0.25].

    ``fixed_positions``: optional {cube_name: xy} overrides pinning specific
    cubes across seeds (e.g. a fixed place target so only the pick cube's
    position varies - the spatial-memory experiment's control).
    """
    rng = np.random.default_rng(seed)
    fixed_positions = fixed_positions or {}
    objects: Dict[str, np.ndarray] = {}
    positions: List[np.ndarray] = []
    for i in range(num_cubes):
        name = f"cube_{i + 1}"
        for _ in range(100):
            if name in fixed_positions:
                xy = np.asarray(fixed_positions[name], dtype=np.float64)[:2]
            elif randomize:
                xy = rng.uniform([0.32, -0.22], [0.68, 0.22])
            else:
                xy = np.asarray([0.4 + 0.2 * i, -0.1 + 0.2 * i])
            if name in fixed_positions or all(
                np.linalg.norm(xy - p[:2]) > 6.0 * cube_half for p in positions
            ):
                break
        pos = np.asarray([xy[0], xy[1], cube_half])
        positions.append(pos)
        objects[name] = pos
    start = np.concatenate([[0.4, 0.0, 0.3], DOWN_QUAT, [0.0]]).astype(
        np.float32
    )
    return SceneKinematicEnvironment(
        ArmEmbodiment(),
        start,
        objects=objects,
        object_half_extents=cube_half,
        image_size=image_size,
        camera_pose_fn=camera_pose_fn,
        grasp_radius_m=grasp_radius_m,
    )


# --- mug_in_drawer scene -----------------------------------------------------
# Geometry mirrors the MugInDrawerEvaluator's reference-parity constants
# (evaluators.py / reference mug_in_drawer_evaluator.py): drawer bottoms are
# 0.4 x 0.65 trays, the mug is a 0.05-radius x 0.1-height body, and success
# means the mug released inside the mugs drawer - the boxes drawer is the
# distractor target the evaluator tracks as a failure mode.
MUG_HALF = np.asarray([0.045, 0.045, 0.05])
DRAWER_HALF = np.asarray([0.2, 0.325, 0.01])
DRAWER_Z = 0.02  # tray bottom slab center: top surface at 0.03


def make_mug_in_drawer_env(
    seed: int,
    image_size: int = 64,
    camera_pose_fn: Optional[Callable[[int], Dict[str, np.ndarray]]] = None,
    randomize: bool = True,
    grasp_radius_m: float = 0.06,
) -> SceneKinematicEnvironment:
    """Mug + two drawer trays in the mug_in_drawer task AABB.

    The mug spawns on the table between the trays; per-seed randomization
    moves the mug AND swaps which side holds the mugs drawer, so a policy
    must identify the correct drawer from the observation.
    """
    rng = np.random.default_rng(seed)
    if randomize:
        mug_xy = rng.uniform([0.32, -0.18], [0.62, 0.18])
        mugs_side = 1.0 if rng.uniform() < 0.5 else -1.0
    else:
        mug_xy = np.asarray([0.45, 0.0])
        mugs_side = 1.0
    objects = {
        "target_mug": np.asarray([mug_xy[0], mug_xy[1], MUG_HALF[2]]),
        "bottom_of_drawer_with_mugs": np.asarray(
            [0.45, mugs_side * 0.5, DRAWER_Z]
        ),
        "bottom_of_drawer_with_boxes": np.asarray(
            [0.45, -mugs_side * 0.5, DRAWER_Z]
        ),
    }
    start = np.concatenate([[0.4, 0.0, 0.3], DOWN_QUAT, [0.0]]).astype(
        np.float32
    )
    if camera_pose_fn is None:
        # Wider framing than the cube scene: both drawer trays (y = +-0.5)
        # must be visible so the policy can identify the correct one.
        wide_pose = look_at_pose7(
            eye=(0.45, -1.15, 0.8), target=(0.45, 0.0, 0.03)
        )

        def camera_pose_fn(step: int) -> Dict[str, np.ndarray]:
            return {"wrist": wide_pose}

    return SceneKinematicEnvironment(
        ArmEmbodiment(),
        start,
        objects=objects,
        object_half_extents={
            "target_mug": MUG_HALF,
            "bottom_of_drawer_with_mugs": DRAWER_HALF,
            "bottom_of_drawer_with_boxes": DRAWER_HALF,
        },
        fixed_objects=[
            "bottom_of_drawer_with_mugs", "bottom_of_drawer_with_boxes",
        ],
        object_colors={
            "target_mug": np.asarray([0.9, 0.9, 0.92]),
            # Color encodes drawer identity (the hermetic stand-in for the
            # reference scene's visually distinct drawer contents).
            "bottom_of_drawer_with_mugs": np.asarray([0.2, 0.6, 0.25]),
            "bottom_of_drawer_with_boxes": np.asarray([0.6, 0.3, 0.15]),
        },
        table_half_extents=(0.45, 0.85, 0.025),
        image_size=image_size,
        camera_pose_fn=camera_pose_fn,
        grasp_radius_m=grasp_radius_m,
    )


def scripted_mug_goals(
    objects: Dict[str, np.ndarray], hover_z: float = 0.24,
    retreat_pos=(0.4, 0.0, 0.3),
) -> List[np.ndarray]:
    """Expert: pick the mug, transport it into the mugs drawer, release."""
    mug = np.asarray(objects["target_mug"][:3], np.float64)
    drawer = np.asarray(objects["bottom_of_drawer_with_mugs"][:3], np.float64)
    place = np.asarray(
        [drawer[0], drawer[1], drawer[2] + DRAWER_HALF[2] + MUG_HALF[2]]
    )
    return [
        _goal([mug[0], mug[1], hover_z], 0.0),        # approach
        _goal(mug, 0.0),                              # descend
        _goal(mug, 1.0),                              # grasp
        _goal([mug[0], mug[1], hover_z], 1.0),        # lift
        _goal([place[0], place[1], hover_z], 1.0),    # transport
        _goal(place, 1.0),                            # lower into drawer
        _goal(place, 0.0),                            # release
        _goal([place[0], place[1], hover_z], 0.0),    # retreat up
        _goal(retreat_pos, 0.0),
    ]


def generate_mug_in_drawer_demos(
    dataset_dir: str,
    num_demos: int,
    seed: int = 0,
    image_size: int = 64,
    camera_pose_fn_factory: Optional[
        Callable[[SceneKinematicEnvironment], Callable]
    ] = None,
    require_expert_success: bool = True,
) -> List[str]:
    """Scripted mug_in_drawer demos, expert-verified by MugInDrawerEvaluator."""
    demo_dirs = []
    for d in range(num_demos):
        env = make_mug_in_drawer_env(seed + d, image_size=image_size)
        if camera_pose_fn_factory is not None:
            env.camera_pose_fn = camera_pose_fn_factory(env)
            env._custom_camera_fn = True
        goals = scripted_mug_goals(env.initial_objects)
        demo_dir = os.path.join(dataset_dir, f"demo_{d:05d}")
        evaluator = MugInDrawerEvaluator()
        evaluator.start_demo(f"demo_{d:05d}", env)

        n = record_scripted_demo(demo_dir, env, goals)
        write_scene_json(demo_dir, env)
        evaluator.evaluate_step(env)
        if require_expert_success and not evaluator.current_success:
            raise AssertionError(
                f"scripted expert failed mug_in_drawer demo {d} "
                f"(objects: {env.get_object_poses()})"
            )
        assert n > 10, f"demo {d} too short ({n} frames)"
        demo_dirs.append(demo_dir)
    return demo_dirs


def generate_cube_stacking_demos(
    dataset_dir: str,
    num_demos: int,
    seed: int = 0,
    num_cubes: int = 2,
    cube_half: float = 0.04,
    image_size: int = 64,
    camera_pose_fn_factory: Optional[
        Callable[[SceneKinematicEnvironment], Callable]
    ] = None,
    require_expert_success: bool = True,
    approach_from=None,
    fixed_positions: Optional[Dict[str, np.ndarray]] = None,
) -> List[str]:
    """Generate ``num_demos`` scripted stacking demos in the demo layout.

    Each demo gets its own randomized scene (seed + index). With
    ``require_expert_success`` the expert's own rollout is judged by
    CubeStackingEvaluator before recording counts - a failing expert is a
    bug, not data.
    """
    demo_dirs = []
    for d in range(num_demos):
        env = make_cube_stacking_env(
            seed + d, num_cubes=num_cubes, cube_half=cube_half,
            image_size=image_size, fixed_positions=fixed_positions,
        )
        if camera_pose_fn_factory is not None:
            env.camera_pose_fn = camera_pose_fn_factory(env)
            env._custom_camera_fn = True
        goals = scripted_stack_goals(
            env.initial_objects, cube_half, approach_from=approach_from
        )
        demo_dir = os.path.join(dataset_dir, f"demo_{d:05d}")
        evaluator = CubeStackingEvaluator(
            num_cubes=num_cubes, cube_side_length=2.0 * cube_half
        )
        evaluator.start_demo(f"demo_{d:05d}", env)

        n = record_scripted_demo(demo_dir, env, goals)
        write_scene_json(demo_dir, env)
        evaluator.evaluate_step(env)
        if require_expert_success and not evaluator.current_success:
            raise AssertionError(
                f"scripted expert failed to stack in demo {d} "
                f"(objects: {env.get_object_poses()})"
            )
        assert n > 10, f"demo {d} too short ({n} frames)"
        demo_dirs.append(demo_dir)
    return demo_dirs


def generate_cube_stacking_recovery_demos(
    dataset_dir: str,
    num_demos: int,
    seed: int = 0,
    num_cubes: int = 2,
    cube_half: float = 0.04,
    image_size: int = 64,
    slip_offset_range_m: Tuple[float, float] = (0.09, 0.2),
    start_index: int = 0,
) -> List[str]:
    """Recovery demonstrations: a mid-transport grasp *slip*, then the expert
    re-picks and finishes the stack.

    Rationale (docs/pages/benchmarks.md, cube_stacking diagnosis): the
    trained policy's closed-loop failures are biased *place* predictions once
    its rollout history leaves the expert distribution; consensus sampling,
    extra on-distribution demos, and history-noise robustification all
    measured no better (the three probes). What the dataset lacks is
    (off-nominal state -> corrective expert action) coverage — the DAgger
    insight, realized here without policy rollouts: during the first
    transport, the carried cube silently slips out of the still-closed
    gripper (env.force_release teleports it > grasp_radius away, no jaw
    event), the expert completes the now-empty transport (a history
    inconsistent with the scene, exactly the drifted conditioning the policy
    sees at eval time), then replans from observed object poses and recovers.
    Keypose labels remain legitimate expert actions throughout.

    Demos are written as demo_{start_index+i:05d}; pass start_index=N to
    append to N standard demos (mixed dataset), and a seed disjoint from the
    standard demos' so scenes differ.
    """
    demo_dirs = []
    for d in range(num_demos):
        env = make_cube_stacking_env(
            seed + d, num_cubes=num_cubes, cube_half=cube_half,
            image_size=image_size,
        )
        rng = np.random.default_rng([seed, d, 1337])
        goals = scripted_stack_goals(env.initial_objects, cube_half)
        assert len(goals) == 8 * (num_cubes - 1) + 1, (
            "scripted_stack_goals layout changed; fix the phase slicing here"
        )
        demo_dir = os.path.join(dataset_dir, f"demo_{start_index + d:05d}")
        evaluator = CubeStackingEvaluator(
            num_cubes=num_cubes, cube_side_length=2.0 * cube_half
        )
        evaluator.start_demo(os.path.basename(demo_dir), env)

        env.reset()
        rec = make_recorder(demo_dir, env)
        rec.record_frame()
        # Pick phase: approach / descend / grasp / lift of the first cube.
        _run_goals(rec, env, goals[:4])
        # Transport with a slip partway: after 1-6 steps toward the place
        # hover, the cube drops out of the closed gripper onto the table,
        # displaced past grasp_radius so it cannot silently re-attach.
        transport = goals[4]
        for _ in range(int(rng.integers(1, 7))):
            env.step(transport)
            rec.record_frame()
        held_names = env.held_object_names()
        assert held_names, (
            f"recovery demo {d}: nothing held at the slip point "
            f"(objects: {env.get_object_poses()})"
        )
        # Keep the landing spot away from the ORIGINAL pick xy too: keypose
        # analysis (and tests) treat the recovery pick as a distinct site,
        # and a landing back on the nominal pick would make the corrective
        # re-pick indistinguishable from the first one.
        pick_xy = env.initial_objects[held_names[0]][:2]
        env.force_release(
            slot=0, position=_sample_slip_position(
                env, rng, cube_half, slip_offset_range_m,
                avoid_xy=[pick_xy],
            )
        )
        # The expert finishes the now-empty transport (drifted history),
        # then observes the scene and replans the remaining stack.
        _run_goals(rec, env, [transport])
        _run_goals(
            rec, env, scripted_stack_goals(env.get_object_poses(), cube_half)
        )
        rec.writer.write_outcome(1)
        write_scene_json(demo_dir, env)
        evaluator.evaluate_step(env)
        assert evaluator.current_success, (
            f"recovery expert failed to re-stack in demo {d} "
            f"(objects: {env.get_object_poses()})"
        )
        assert rec.t > 10, f"recovery demo {d} too short ({rec.t} frames)"
        demo_dirs.append(demo_dir)
    return demo_dirs


def _sample_slip_position(
    env: SceneKinematicEnvironment, rng, cube_half: float,
    offset_range_m: Tuple[float, float],
    avoid_xy=None,
    avoid_radius_m: float = 0.07,
) -> np.ndarray:
    """A table landing spot for the slipped cube: displaced from the gripper
    by a planar offset in ``offset_range_m`` (min must exceed grasp_radius),
    inside the spawn workspace, clear of the other cubes, and at least
    ``avoid_radius_m`` from every xy in ``avoid_xy`` (e.g. the original pick
    site, so the recovery pick is a structurally distinct keypose)."""
    lo, hi = offset_range_m
    assert lo > env.grasp_radius_m, (
        f"slip offset min {lo} must exceed grasp_radius {env.grasp_radius_m}"
    )
    eef_xy = env.get_policy_state()[:2]
    held = set(env.held_object_names())
    others = [p[:3] for n, p in env.get_object_poses().items()
              if n not in held]
    avoid = [np.asarray(a, np.float64)[:2] for a in (avoid_xy or [])]
    for _ in range(100):
        angle = rng.uniform(0.0, 2.0 * np.pi)
        r = rng.uniform(lo, hi)
        xy = np.clip(
            eef_xy + r * np.asarray([np.cos(angle), np.sin(angle)]),
            [0.32, -0.22], [0.68, 0.22],
        )
        # Re-check the offset after clipping (a clip can pull the spot back
        # under grasp_radius near the workspace edge) and keep it off the
        # other cubes so the drop never lands an accidental stack.
        if np.linalg.norm(xy - eef_xy) <= env.grasp_radius_m + 0.01:
            continue
        if any(np.linalg.norm(xy - a) <= avoid_radius_m for a in avoid):
            continue
        if all(np.linalg.norm(xy - p[:2]) > 3.0 * cube_half for p in others):
            return np.asarray([xy[0], xy[1], cube_half])
    raise AssertionError(
        f"no valid slip landing spot around eef {eef_xy} "
        f"(objects: {env.get_object_poses()})"
    )


# --- on-policy corrective demonstrations (DAgger) ----------------------------


def record_policy_prefix(
    rec,
    env: SceneKinematicEnvironment,
    policy,
    max_goals: int,
    max_steps: int = 160,
    max_num_steps_to_goal: int = 30,
) -> str:
    """Drive ``env`` with ``policy`` while recording every frame, stopping
    BEFORE the policy can release a held object.

    The goal-management loop mirrors runner.run_one_episode (goal queue,
    reached check, per-goal timeout) so the recorded trajectory is exactly
    what closed-loop evaluation would execute — but every env.step lands in
    the demo recorder, and a goal that would OPEN the gripper while an object
    is held is intercepted instead of executed (the expert takes over before
    the policy's possibly-drifted place happens, so no policy action ever
    becomes a release keypose label).

    Returns the stop reason: 'release_intercepted' | 'goal_budget' |
    'exhausted' | 'step_budget'.
    """
    embodiment = env.embodiment
    goal_queue: List = []
    current_goal = None
    current_is_intermediate = False
    steps_to_goal = 0
    goals_used = 0
    for _ in range(max_steps):
        policy.step(env)
        state = np.asarray(env.get_policy_state())
        need_new_goal = current_goal is None
        if current_goal is not None:
            if is_goal_reached(
                embodiment, state, current_goal,
                is_intermediate_goal=current_is_intermediate,
            ):
                current_goal = None
                steps_to_goal = 0
                need_new_goal = not goal_queue
            elif steps_to_goal >= max_num_steps_to_goal:
                current_goal = None
                steps_to_goal = 0
                need_new_goal = not goal_queue
        if need_new_goal and not goal_queue:
            if goals_used >= max_goals:
                return "goal_budget"
            new_goals = policy.get_new_goal(env)
            goals_used += 1
            if not new_goals:
                return "exhausted"
            new_goals, flags = add_intermediate_goals(
                embodiment, state, new_goals, None
            )
            goal_queue.extend(zip(new_goals, flags))
        if current_goal is None and goal_queue:
            current_goal, current_is_intermediate = goal_queue.pop(0)
            steps_to_goal = 0
        if (
            current_goal is not None
            and env.held_object_names()
            and float(current_goal[7]) < 0.5
        ):
            return "release_intercepted"
        env.step(current_goal)
        rec.record_frame()
        steps_to_goal += 1
    return "step_budget"


def scripted_completion_goals(
    env: SceneKinematicEnvironment,
    cube_half: float,
    hover_z: float = 0.22,
    retreat_pos=(0.4, 0.0, 0.3),
    stacked_tol_factor: float = 0.75,
) -> List[np.ndarray]:
    """Expert goal sequence completing the cube stack from ANY state.

    The counterpart of scripted_stack_goals for mid-episode takeover: it
    reads the CURRENT object poses and grasp state instead of assuming the
    initial scene. Three cases:
      - a non-base cube is in hand -> finish the interrupted transport with
        the correct place on the stack (the corrective action the
        place-drift diagnosis says the dataset lacks);
      - the base cube itself is in hand -> set it down at the current xy,
        then replan;
      - nothing held -> standard pick-and-place for every cube not already
        within ``stacked_tol_factor * cube_half`` of its stack slot.
    """
    held = env.held_object_names()
    poses = {
        k: np.asarray(v[:3], np.float64)
        for k, v in env.get_object_poses().items()
    }
    names = sorted(poses)
    assert names[0] == "cube_1", f"expected cube_1..cube_N, got {names}"
    goals: List[np.ndarray] = []
    if held:
        assert len(held) == 1, f"one arm, multiple held: {held}"
        name = held[0]
        eef = np.asarray(env.get_policy_state()[:3], np.float64)
        if name == names[0]:
            # The base is in hand: put it down here, then replan the stack
            # around its new resting position.
            down = np.asarray([eef[0], eef[1], cube_half])
            goals += [
                _goal(down, 1.0),                          # descend
                _goal(down, 0.0),                          # release
                _goal([down[0], down[1], hover_z], 0.0),   # retreat up
            ]
            poses[name] = down
        else:
            level = names.index(name)
            base = poses[names[0]]
            place = np.asarray(
                [base[0], base[1], base[2] + 2.0 * cube_half * level]
            )
            goals += [
                _goal([eef[0], eef[1], hover_z], 1.0),       # lift in place
                _goal([place[0], place[1], hover_z], 1.0),   # transport
                _goal(place, 1.0),                            # place
                _goal(place, 0.0),                            # release
                _goal([place[0], place[1], hover_z], 0.0),   # retreat up
            ]
            poses[name] = place
    base = poses[names[0]]
    for level, name in enumerate(names[1:], start=1):
        target = base + np.asarray([0.0, 0.0, 2.0 * cube_half * level])
        if np.linalg.norm(poses[name] - target) <= (
            stacked_tol_factor * cube_half
        ):
            continue  # already seated on the stack
        pick = poses[name]
        goals += [
            _goal([pick[0], pick[1], hover_z], 0.0),       # approach
            _goal(pick, 0.0),                              # descend
            _goal(pick, 1.0),                              # grasp
            _goal([pick[0], pick[1], hover_z], 1.0),       # lift
            _goal([target[0], target[1], hover_z], 1.0),   # transport
            _goal(target, 1.0),                             # place
            _goal(target, 0.0),                             # release
            _goal([target[0], target[1], hover_z], 0.0),   # retreat up
        ]
    goals.append(_goal(retreat_pos, 0.0))
    return goals


def generate_cube_stacking_dagger_demos(
    dataset_dir: str,
    num_demos: int,
    make_policy: Callable[[], object],
    seed: int = 0,
    num_cubes: int = 2,
    cube_half: float = 0.04,
    image_size: int = 64,
    start_index: int = 0,
    policy_goal_budget_range: Tuple[int, int] = (3, 10),
    max_policy_steps: int = 160,
    max_num_steps_to_goal: int = 30,
) -> Tuple[List[str], List[Dict]]:
    """On-policy corrective demonstrations: the TRAINED policy drives, the
    scripted expert takes over and finishes (HG-DAgger).

    This is the capability the place-drift diagnosis calls for
    (docs/pages/benchmarks.md): the recorded gripper history is the policy's
    OWN rollout — including whatever drift it accumulates — and the keypose
    labels after takeover are the expert's corrective actions computed from
    the observed object poses (scripted_completion_goals). The policy phase
    ends at a randomized goal budget (covering post-pick / post-lift /
    mid-transport states) or the moment the policy tries to release a held
    cube, whichever first, so no policy action is ever a release label. This
    realizes, without teleoperation, the coverage the reference buys with
    100-130 human demos per task (model_cards/model_overview.md:114).

    ``make_policy``: zero-arg factory returning a fresh PolicyBase per demo
    (fresh mapper state). Demos are written as demo_{start_index+i:05d} on
    scenes seeded ``seed + i`` — pass a seed range disjoint from the training
    scenes (these rollouts are harvest scenes, not eval scenes).

    Returns (demo_dirs, per-demo rollout stats).
    """
    assert num_cubes == 2, (
        "dagger completion planning is validated for 2-cube scenes"
    )
    demo_dirs, stats = [], []
    for d in range(num_demos):
        env = make_cube_stacking_env(
            seed + d, num_cubes=num_cubes, cube_half=cube_half,
            image_size=image_size,
        )
        rng = np.random.default_rng([seed, d, 97])
        policy = make_policy()
        demo_dir = os.path.join(dataset_dir, f"demo_{start_index + d:05d}")
        evaluator = CubeStackingEvaluator(
            num_cubes=num_cubes, cube_side_length=2.0 * cube_half
        )
        evaluator.start_demo(os.path.basename(demo_dir), env)

        env.reset()
        rec = make_recorder(demo_dir, env)
        rec.record_frame()
        budget = int(rng.integers(*policy_goal_budget_range))
        reason = record_policy_prefix(
            rec, env, policy, max_goals=budget, max_steps=max_policy_steps,
            max_num_steps_to_goal=max_num_steps_to_goal,
        )
        prefix_frames = rec.t
        held_at_takeover = list(env.held_object_names())
        _run_goals(rec, env, scripted_completion_goals(env, cube_half))
        rec.writer.write_outcome(1)
        write_scene_json(demo_dir, env)
        evaluator.evaluate_step(env)
        assert evaluator.current_success, (
            f"expert completion failed in dagger demo {d} after takeover "
            f"'{reason}' (objects: {env.get_object_poses()})"
        )
        assert rec.t > 10, f"dagger demo {d} too short ({rec.t} frames)"
        stats.append({
            "demo": os.path.basename(demo_dir),
            "stop_reason": reason,
            "policy_goal_budget": budget,
            "policy_frames": prefix_frames,
            "total_frames": rec.t,
            "held_at_takeover": held_at_takeover,
        })
        demo_dirs.append(demo_dir)
    return demo_dirs, stats


# --- GR1 humanoid tasks: drill_in_box / stick_in_bin -------------------------
# Hermetic stand-ins for the reference's two GR1T2-Right tasks (reference:
# tasks/task_definitions/{drill_in_box,stick_in_bin}; gym ids
# Isaac-*-GR1T2-Right-v0 per embodiments/registry.py). The scenes live inside
# each task's mapping AABB (mapping/constants.py) so fusion sees them; the
# right hand does the manipulation and the head camera (pov) follows the
# scripted head-yaw schedule, producing real head-turn keypose events
# (embodiments/humanoid.py get_head_turn_events).

# Scripted head-yaw waypoints (rad). The expert overshoots past the object
# gaze then settles back, placing the single yaw-direction REVERSAL before
# any grasp keyposes - that reversal, >45 deg away from the previous keypose
# (demo frame 0 at YAW_CONTAINER), is what the head-turn detector keys on.
YAW_OBJECT = 0.5
YAW_CONTAINER = -0.5
YAW_OVERSHOOT = 0.4

DRILL_HALF = np.asarray([0.035, 0.02, 0.035])
DRILL_TRAY_HALF = np.asarray([0.2, 0.15, 0.01])  # open_box footprint 0.4 x 0.3
STICK_HALF = np.asarray([0.02, 0.02, 0.09])
DRUM_TRAY_HALF = np.asarray([0.2, 0.2, 0.01])  # inside the 0.3 success radius


def _hgoal(l_pos, l_closed, r_pos, r_closed, head_yaw) -> np.ndarray:
    """17-dim humanoid policy-state goal (both hands pointing down)."""
    return np.concatenate(
        [
            np.asarray(l_pos, np.float32), DOWN_QUAT, [np.float32(l_closed)],
            np.asarray(r_pos, np.float32), DOWN_QUAT, [np.float32(r_closed)],
            [np.float32(head_yaw)],
        ]
    )


def _gaze_target_xy(head_xy, yaw: float, distance: float) -> np.ndarray:
    return np.asarray(
        [
            head_xy[0] - np.sin(yaw) * distance,
            head_xy[1] + np.cos(yaw) * distance,
        ]
    )


def scripted_humanoid_pick_place_goals(
    obj_pos,
    place_pos,
    staging_r,
    rest_l,
    hover_dz: float = 0.2,
    yaw_object: float = YAW_OBJECT,
    yaw_container: float = YAW_CONTAINER,
) -> List[np.ndarray]:
    """Right-handed pick-and-place with a head-yaw schedule.

    Phases: head sweep (overshoot + settle) -> approach/descend/grasp at the
    object gaze -> lift -> head turn to the container -> transport/lower/
    release -> retreat with the head returning to neutral. The left hand
    stays parked at ``rest_l`` (the reference GR1 tasks are right-handed).
    """
    obj = np.asarray(obj_pos, np.float64)
    place = np.asarray(place_pos, np.float64)
    hover_obj = [obj[0], obj[1], obj[2] + hover_dz]
    hover_place = [place[0], place[1], place[2] + hover_dz]
    g = lambda r_pos, r_closed, yaw: _hgoal(rest_l, 0.0, r_pos, r_closed, yaw)
    return [
        g(staging_r, 0.0, yaw_object + YAW_OVERSHOOT),  # head sweep overshoot
        g(staging_r, 0.0, yaw_object),                  # settle on the object
        g(hover_obj, 0.0, yaw_object),                  # approach
        g(obj, 0.0, yaw_object),                        # descend
        g(obj, 1.0, yaw_object),                        # grasp
        g(hover_obj, 1.0, yaw_object),                  # lift
        g(hover_obj, 1.0, yaw_container),               # look at the container
        g(hover_place, 1.0, yaw_container),             # transport
        g(place, 1.0, yaw_container),                   # lower
        g(place, 0.0, yaw_container),                   # release
        g(hover_place, 0.0, yaw_container),             # retreat up
        g(staging_r, 0.0, 0.0),                         # retreat, head neutral
    ]


def _make_humanoid_pick_place_env(
    seed: int,
    *,
    table_center,
    table_half,
    head_position,
    object_name: str,
    object_half,
    object_color,
    container_name: str,
    container_center,
    container_half,
    container_color,
    obj_region_lo,
    obj_region_hi,
    image_size: int,
    randomize: bool,
) -> SceneKinematicEnvironment:
    rng = np.random.default_rng(seed)
    if randomize:
        obj_xy = rng.uniform(obj_region_lo, obj_region_hi)
    else:
        obj_xy = (np.asarray(obj_region_lo) + np.asarray(obj_region_hi)) / 2.0
    table_top = float(table_center[2]) + float(table_half[2])
    obj_pos = np.asarray([obj_xy[0], obj_xy[1], table_top + object_half[2]])
    container = np.asarray(container_center, np.float64)

    # Right hand stages near the container side; left hand parks mirrored.
    staging_r = np.asarray(
        [container[0] - 0.02, head_position[1] + 0.25, table_top + 0.30]
    )
    rest_l = np.asarray(
        [2.0 * table_center[0] - container[0] - 0.3,
         head_position[1] + 0.25, table_top + 0.30]
    )
    initial = _hgoal(rest_l, 0.0, staging_r, 0.0, YAW_CONTAINER)
    return SceneKinematicEnvironment(
        HumanoidEmbodiment(),
        initial,
        objects={object_name: obj_pos, container_name: container},
        object_half_extents={
            object_name: object_half,
            container_name: container_half,
        },
        fixed_objects=[container_name],
        object_colors={
            object_name: object_color,
            container_name: container_color,
        },
        table_center=table_center,
        table_half_extents=table_half,
        head_position=head_position,
        max_head_yaw_step_rad=0.2,
        image_size=image_size,
        grasp_radius_m=0.06,
    )


def make_drill_in_box_env(
    seed: int, image_size: int = 64, randomize: bool = True
) -> SceneKinematicEnvironment:
    """power_drill + open_box tray inside the drill_in_box AABB
    (mapping/constants.py x[-0.37, 0.95], y[-0.75, 0.75])."""
    head = np.asarray([0.3, -0.75, 0.65])
    # Object spawns around the yaw=+0.5 gaze point; the box sits at the
    # yaw=-0.5 gaze point so each is centered in view at its phase.
    obj_c = _gaze_target_xy(head[:2], YAW_OBJECT, 0.7)
    box_c = _gaze_target_xy(head[:2], YAW_CONTAINER, 0.7)
    return _make_humanoid_pick_place_env(
        seed,
        table_center=(0.3, 0.0, -0.025),
        table_half=(0.6, 0.7, 0.025),
        head_position=head,
        object_name="power_drill",
        object_half=DRILL_HALF,
        object_color=np.asarray([0.85, 0.75, 0.1]),
        container_name="open_box",
        container_center=[box_c[0], box_c[1], 0.02],
        container_half=DRILL_TRAY_HALF,
        container_color=np.asarray([0.55, 0.35, 0.2]),
        obj_region_lo=obj_c - 0.1,
        obj_region_hi=obj_c + 0.1,
        image_size=image_size,
        randomize=randomize,
    )


def make_stick_in_bin_env(
    seed: int, image_size: int = 64, randomize: bool = True
) -> SceneKinematicEnvironment:
    """pick_up_object (stick) + open_drum tray inside the stick_in_bin AABB
    (mapping/constants.py x[3.7, 5.5], y[1.5, 3.2], z[0.44, 1.25])."""
    head = np.asarray([4.6, 1.6, 1.15])
    obj_c = _gaze_target_xy(head[:2], YAW_OBJECT, 0.7)
    drum_c = _gaze_target_xy(head[:2], YAW_CONTAINER, 0.7)
    return _make_humanoid_pick_place_env(
        seed,
        table_center=(4.6, 2.35, 0.475),
        table_half=(0.75, 0.7, 0.025),
        head_position=head,
        object_name="pick_up_object",
        object_half=STICK_HALF,
        object_color=np.asarray([0.2, 0.75, 0.8]),
        container_name="open_drum",
        container_center=[drum_c[0], drum_c[1], 0.52],
        container_half=DRUM_TRAY_HALF,
        container_color=np.asarray([0.35, 0.35, 0.6]),
        obj_region_lo=obj_c - 0.1,
        obj_region_hi=obj_c + 0.1,
        image_size=image_size,
        randomize=randomize,
    )


def _generate_humanoid_demos(
    dataset_dir: str,
    num_demos: int,
    seed: int,
    image_size: int,
    make_env,
    object_name: str,
    container_name: str,
    make_evaluator,
    camera_pose_fn_factory=None,
    require_expert_success: bool = True,
) -> List[str]:
    demo_dirs = []
    for d in range(num_demos):
        env = make_env(seed + d, image_size=image_size)
        if camera_pose_fn_factory is not None:
            env.camera_pose_fn = camera_pose_fn_factory(env)
            env._custom_camera_fn = True
        obj = env.initial_objects[object_name][:3]
        container = env.initial_objects[container_name][:3]
        place = np.asarray(
            [
                container[0],
                container[1],
                container[2]
                + env.object_half_map[container_name][2]
                + env.object_half_map[object_name][2],
            ]
        )
        staging_r = env.initial_state[8:11]
        rest_l = env.initial_state[0:3]
        goals = scripted_humanoid_pick_place_goals(
            obj, place, staging_r, rest_l
        )
        demo_dir = os.path.join(dataset_dir, f"demo_{d:05d}")
        evaluator = make_evaluator()
        evaluator.start_demo(f"demo_{d:05d}", env)
        n = record_scripted_demo(demo_dir, env, goals)
        write_scene_json(demo_dir, env)
        evaluator.evaluate_step(env)
        if require_expert_success and not evaluator.current_success:
            raise AssertionError(
                f"scripted expert failed {object_name} demo {d} "
                f"(objects: {env.get_object_poses()})"
            )
        # The head-yaw schedule must yield a detectable head-turn event -
        # the GR1 tasks' keypose mode depends on it (registry.py
        # HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN).
        states = DemoDataset.load_robot_states(demo_dir)
        base = env.embodiment.extract_keypose_indices(
            states, [5, 15], KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION
        )
        turns = env.embodiment.get_head_turn_events(
            states[:, 36], base.tolist()
        )
        assert turns, f"expert produced no head-turn keypose in demo {d}"
        assert n > 10, f"demo {d} too short ({n} frames)"
        demo_dirs.append(demo_dir)
    return demo_dirs


def generate_drill_in_box_demos(
    dataset_dir: str, num_demos: int, seed: int = 0, image_size: int = 64,
    camera_pose_fn_factory=None, require_expert_success: bool = True,
) -> List[str]:
    """Scripted drill_in_box demos, expert-verified by DrillInBoxEvaluator."""
    return _generate_humanoid_demos(
        dataset_dir, num_demos, seed, image_size, make_drill_in_box_env,
        "power_drill", "open_box", DrillInBoxEvaluator,
        camera_pose_fn_factory, require_expert_success,
    )


def generate_stick_in_bin_demos(
    dataset_dir: str, num_demos: int, seed: int = 0, image_size: int = 64,
    camera_pose_fn_factory=None, require_expert_success: bool = True,
) -> List[str]:
    """Scripted stick_in_bin demos, expert-verified by StickInBinEvaluator."""
    return _generate_humanoid_demos(
        dataset_dir, num_demos, seed, image_size, make_stick_in_bin_env,
        "pick_up_object", "open_drum", StickInBinEvaluator,
        camera_pose_fn_factory, require_expert_success,
    )
