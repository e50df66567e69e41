"""Scripted cube-stacking expert and demo recorder for the scene world.

The port's own copy of the scene-world part of
``nvblox_mindmap_tpu/closed_loop/scripted.py`` (``:35-430``). Upstream
generates its demonstrations with Isaac Lab Mimic experts and records them
through ``IsaacLabWriter`` (``mindmap/run_isaaclab_datagen.py``,
``mindmap/isaaclab_utils/isaaclab_writer.py``). Here a deterministic
pick-and-place expert stacks the cubes in ``SceneKinematicEnvironment``, and
every sim step is written in the recorded demo layout (RGB / depth /
semantic PNGs, pose and intrinsics, 9-dim arm robot states whose jaws ramp,
so the keypose machinery's grasp-event detection sees the signal shape of
real jaws), with a ``scene.json`` from which ``env_from_scene_json``
rebuilds the world, the JAX package's files included (all four tasks; the
humanoid worlds take the port's ``HumanoidEmbodiment``).

The demo-set generators, recovery and DAgger demos and the humanoid recorder
are not ported yet (``make_recorder`` raises for a humanoid world).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.goals import is_goal_reached
from nvblox_mindmap_torch.closed_loop.scene import SceneKinematicEnvironment
from nvblox_mindmap_torch.data.writer import DemoWriter
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment

HUMANOID_RECORDER_SLICE = ("the humanoid recorder slice (HumanoidDemoRecorder and the "
                           "demo-set generators; ROADMAP.md queue 1)")

# Jaw positions for the recorded 9-dim arm robot state: fully open matches
# the embodiment's GRIPPER_OPEN_THRESHOLD; the ramp speed (7.5 mm/frame)
# clears the grasp-event speed threshold (arm.py gripper_speed_threshold).
JAW_OPEN = 0.04
JAW_CLOSED = 0.01
JAW_SPEED = 0.0075

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


def make_recorder(demo_dir: str, env: SceneKinematicEnvironment):
    if isinstance(env.embodiment, ArmEmbodiment):
        return ArmDemoRecorder(demo_dir, env)
    raise NotImplementedError(f"recording humanoid demos is added by {HUMANOID_RECORDER_SLICE}")


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
