"""Closed-loop evaluators: per-demo success tracking and summaries.

The port's own copy of ``nvblox_mindmap_tpu/closed_loop/evaluators.py``
(upstream ``mindmap/closed_loop/evaluators/*``). An evaluator observes every
sim step, finalizes a per-demo outcome, and summarizes a success rate and a
JSON evaluation file. CubeStacking and MugInDrawer judge success by task
semantics from the object poses of ``EnvironmentBase.get_object_poses``:
success means cubes actually stacked or the mug actually released in the
right drawer, not waypoint proximity (upstream
``cube_stacking_evaluator.py:1-340``, ``mug_in_drawer_evaluator.py:1-285``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.environment import EnvironmentBase
from nvblox_mindmap_torch.embodiments.arm import is_gripper_open
from nvblox_mindmap_torch.mapping.constants import Tasks


class EvaluatorBase:
    def __init__(self, eval_file_path: Optional[str] = None):
        self.demo_outcomes: Dict[str, bool] = {}
        self.eval_dict: Dict[str, Dict] = {}
        self.eval_file_path = eval_file_path
        self._current_success = False
        self._demo_name = ""
        self._retry_idx = 0

    def start_demo(self, demo_name: str, env: Optional[EnvironmentBase] = None,
                   retry_idx: int = 0):
        self._current_success = False
        self._demo_name = demo_name
        self._retry_idx = retry_idx

    @property
    def current_success(self) -> bool:
        """The evaluator's live success judgment for the running episode."""
        return self._current_success

    def evaluate_step(self, env: EnvironmentBase):
        if env.is_success():
            self._current_success = True

    def _record_attempt(self, demo_name: str, success: bool,
                        extras: Optional[Dict] = None) -> bool:
        """Shared finalize bookkeeping: best-over-retries outcome, one
        eval_dict entry per attempt, eval-file refresh."""
        self._current_success = success
        # Keep the best outcome over retries.
        prev = self.demo_outcomes.get(demo_name, False)
        self.demo_outcomes[demo_name] = prev or success
        entry = {"demo": demo_name, "success": bool(success)}
        if extras:
            entry.update(extras)
        self.eval_dict[f"{demo_name}_{self._retry_idx}"] = entry
        self.maybe_write_eval_file()
        return success

    def finalize_demo(self, demo_name: str,
                      env: Optional[EnvironmentBase] = None) -> bool:
        return self._record_attempt(demo_name, self._current_success)

    def success_rate(self) -> float:
        if not self.demo_outcomes:
            return 0.0
        return float(np.mean([v for v in self.demo_outcomes.values()]))

    def summarize_demos(self) -> Dict:
        summary = {
            "num_demos": len(self.demo_outcomes),
            "num_successes": int(sum(self.demo_outcomes.values())),
            "success_rate": self.success_rate(),
            "outcomes": {k: bool(v) for k, v in self.demo_outcomes.items()},
        }
        self.eval_dict["summary"] = summary
        self.maybe_write_eval_file()
        return summary

    def maybe_write_eval_file(self):
        if self.eval_file_path:
            self.write_eval_file(self.eval_file_path)

    def write_eval_file(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = dict(self.eval_dict)
        payload.setdefault("summary", {
            "num_demos": len(self.demo_outcomes),
            "success_rate": self.success_rate(),
        })
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=float)


class BasicEvaluator(EvaluatorBase):
    """Success from the environment's own success term."""


class WaypointEvaluator(EvaluatorBase):
    """Success when the end-effector has visited all required waypoints
    (machinery-test proxy; the task evaluators below judge real semantics)."""

    def __init__(self, waypoints: List[np.ndarray], tolerance_m: float = 0.03,
                 eval_file_path: Optional[str] = None):
        super().__init__(eval_file_path)
        self.waypoints = [np.asarray(w) for w in waypoints]
        self.tolerance_m = tolerance_m
        self._visited: List[bool] = []

    def start_demo(self, demo_name: str, env=None, retry_idx: int = 0):
        super().start_demo(demo_name, env, retry_idx)
        self._visited = [False] * len(self.waypoints)

    def evaluate_step(self, env: EnvironmentBase):
        eef = np.asarray(env.get_policy_state())[:3]
        for i, w in enumerate(self.waypoints):
            if not self._visited[i] and np.linalg.norm(eef - w) < self.tolerance_m:
                self._visited[i] = True
        if all(self._visited):
            self._current_success = True


class ArmEvaluatorBase(EvaluatorBase):
    """Shared gripper-openness check for the arm task evaluators
    (reference: evaluators/arm_evaluator.py:25-37)."""

    def _gripper_is_open(self, env: EnvironmentBase) -> bool:
        robot_state = np.asarray(env.get_robot_state())
        if robot_state.shape[-1] >= 9:  # pos3 + quat4 + jaws2
            return is_gripper_open(robot_state[7:9])
        # Policy-state fallback: closedness in [0, 1] at index 7.
        return float(robot_state[7]) < 0.5


class CubeStackingEvaluator(ArmEvaluatorBase):
    """Stack-count tracking (reference: cube_stacking_evaluator.py).

    Objects ``cube_1..cube_N`` come from ``env.get_object_poses()``. Success =
    all cubes on one stack while the gripper is open (the robot released the
    top cube).
    """

    def __init__(self, num_cubes: int = 3, cube_side_length: float = 0.045,
                 eval_file_path: Optional[str] = None):
        super().__init__(eval_file_path)
        self.num_cubes = num_cubes
        self.cube_side_length = cube_side_length
        self.min_distance_xy_moved_thresh = cube_side_length / 2.0
        self.min_distance_z_lifted_thresh = cube_side_length / 2.0
        # 20% conservative margin (reference :66-69).
        self.min_distance_z_stacked_thresh = cube_side_length * 0.8

    def _cube_positions(self, env: EnvironmentBase) -> np.ndarray:
        poses = env.get_object_poses()
        missing = [f"cube_{i + 1}" for i in range(self.num_cubes)
                   if f"cube_{i + 1}" not in poses]
        if missing:
            raise KeyError(
                f"CubeStackingEvaluator needs object poses {missing} from the "
                "environment (EnvironmentBase.get_object_poses)"
            )
        return np.stack(
            [np.asarray(poses[f"cube_{i + 1}"])[:3] for i in range(self.num_cubes)]
        )

    def start_demo(self, demo_name: str, env: Optional[EnvironmentBase] = None,
                   retry_idx: int = 0):
        super().start_demo(demo_name, env, retry_idx)
        assert env is not None, "task evaluators need the environment at start"
        self.initial_cube_positions = self._cube_positions(env)
        self.cubes_have_been_lifted = np.zeros(self.num_cubes, dtype=bool)
        self.cubes_have_been_moved = np.zeros(self.num_cubes, dtype=bool)
        self.max_num_stacked_cubes = 0
        self.max_num_stacked_cubes_with_open_gripper = 0
        self.current_num_stacked_cubes = 0

    def _num_stacked_cubes(self, cube_positions: np.ndarray) -> int:
        """Cubes on the highest stack, judged by pairwise z separation
        (reference :273-304). Deliberately z-only, matching the reference
        heuristic exactly - physics guarantees resting cubes at distinct
        heights are supported by something; a synthetic env that floats
        cubes at different z anywhere in the scene would over-count."""
        best = 0
        z = cube_positions[:, 2]
        for i in range(self.num_cubes):
            on_stack = 1
            for j in range(i + 1, self.num_cubes):
                if abs(z[i] - z[j]) > self.min_distance_z_stacked_thresh:
                    on_stack += 1
            best = max(best, on_stack)
        return best

    def evaluate_step(self, env: EnvironmentBase):
        cube_positions = self._cube_positions(env)
        delta_z = cube_positions[:, 2] - self.initial_cube_positions[:, 2]
        self.cubes_have_been_lifted |= delta_z > self.min_distance_z_lifted_thresh
        delta_xy = np.linalg.norm(
            cube_positions[:, :2] - self.initial_cube_positions[:, :2], axis=-1
        )
        self.cubes_have_been_moved |= delta_xy > self.min_distance_xy_moved_thresh

        n_stacked = self._num_stacked_cubes(cube_positions)
        self.max_num_stacked_cubes = max(self.max_num_stacked_cubes, n_stacked)
        if (self._gripper_is_open(env)
                and n_stacked > self.max_num_stacked_cubes_with_open_gripper):
            self.max_num_stacked_cubes_with_open_gripper = n_stacked
        self.current_num_stacked_cubes = n_stacked
        self._current_success = (
            self.max_num_stacked_cubes_with_open_gripper == self.num_cubes
        )

    def finalize_demo(self, demo_name: str,
                      env: Optional[EnvironmentBase] = None) -> bool:
        if env is not None:
            self.evaluate_step(env)
        success = self.max_num_stacked_cubes_with_open_gripper == self.num_cubes
        return self._record_attempt(demo_name, success, {
            "num_stacked_cubes": int(self.current_num_stacked_cubes),
            "cubes_have_been_lifted": int(self.cubes_have_been_lifted.sum()),
            "cubes_have_been_moved": int(self.cubes_have_been_moved.sum()),
            "max_num_stacked_cubes": int(self.max_num_stacked_cubes),
            "max_num_stacked_cubes_with_open_gripper": int(
                self.max_num_stacked_cubes_with_open_gripper
            ),
        })

    def summarize_demos(self) -> Dict:
        # Per-attempt means (retries included, like the reference's count
        # dicts); num_demos counts unique demos so it is consistent with
        # success_rate, with num_attempts reported alongside.
        attempts = [v for k, v in self.eval_dict.items()
                    if k not in ("summary", "metadata")]
        n = max(len(attempts), 1)
        summary = {
            "num_demos": len(self.demo_outcomes),
            "num_attempts": len(attempts),
            "success_rate": self.success_rate(),
            "mean_num_lifted_cubes":
                sum(d["cubes_have_been_lifted"] for d in attempts) / n,
            "mean_num_moved_cubes":
                sum(d["cubes_have_been_moved"] for d in attempts) / n,
            "mean_num_stacked_cubes":
                sum(d["max_num_stacked_cubes"] for d in attempts) / n,
            "mean_num_stacked_cubes_with_open_gripper":
                sum(d["max_num_stacked_cubes_with_open_gripper"]
                    for d in attempts) / n,
            "full_stack_at_demo_end_rate":
                sum(d["num_stacked_cubes"] == self.num_cubes
                    for d in attempts) / n,
            "outcomes": {k: bool(v) for k, v in self.demo_outcomes.items()},
        }
        self.eval_dict["summary"] = summary
        self.maybe_write_eval_file()
        return summary


class MugInDrawerEvaluator(ArmEvaluatorBase):
    """Mug lifted / moved / released-in-the-right-drawer tracking
    (reference: mug_in_drawer_evaluator.py). Objects: ``target_mug``,
    ``bottom_of_drawer_with_mugs``, ``bottom_of_drawer_with_boxes``."""

    MUG = "target_mug"
    DRAWER = "bottom_of_drawer_with_mugs"
    WRONG_DRAWER = "bottom_of_drawer_with_boxes"

    def __init__(self, eval_file_path: Optional[str] = None):
        super().__init__(eval_file_path)
        self.drawer_size = np.array([0.4, 0.65, 0.1])
        self.mug_radius = 0.05
        self.mug_height = 0.1
        self.min_distance_xy_moved_thresh = self.mug_radius
        self.min_distance_z_lifted_thresh = self.mug_height / 2.0

    def _position(self, env: EnvironmentBase, name: str) -> np.ndarray:
        poses = env.get_object_poses()
        if name not in poses:
            raise KeyError(
                f"MugInDrawerEvaluator needs object pose {name!r} from the "
                "environment (EnvironmentBase.get_object_poses)"
            )
        return np.asarray(poses[name])[:3]

    def start_demo(self, demo_name: str, env: Optional[EnvironmentBase] = None,
                   retry_idx: int = 0):
        super().start_demo(demo_name, env, retry_idx)
        assert env is not None, "task evaluators need the environment at start"
        self.initial_mug_position = self._position(env, self.MUG)
        self.drawer_position = self._position(env, self.DRAWER)
        self.wrong_drawer_position = self._position(env, self.WRONG_DRAWER)
        self.mug_has_been_lifted = False
        self.mug_has_been_moved = False
        self.mug_has_been_in_drawer = False
        self.mug_has_been_in_wrong_drawer = False
        self.mug_has_been_released_in_drawer = False

    def _mug_is_in_drawer(self, mug_position: np.ndarray,
                          drawer_position: np.ndarray) -> bool:
        """Drawer z is its bottom; 1 cm tolerance below (reference :262-286)."""
        half = self.drawer_size / 2.0
        in_x = (drawer_position[0] - half[0] < mug_position[0]
                < drawer_position[0] + half[0])
        in_y = (drawer_position[1] - half[1] < mug_position[1]
                < drawer_position[1] + half[1])
        in_z = (drawer_position[2] - 1e-2 < mug_position[2]
                < drawer_position[2] + self.drawer_size[2])
        return bool(in_x and in_y and in_z)

    def evaluate_step(self, env: EnvironmentBase):
        mug = self._position(env, self.MUG)
        self.mug_has_been_lifted |= bool(
            mug[2] - self.initial_mug_position[2]
            > self.min_distance_z_lifted_thresh
        )
        self.mug_has_been_moved |= bool(
            np.linalg.norm(mug[:2] - self.initial_mug_position[:2])
            > self.min_distance_xy_moved_thresh
        )
        in_drawer = self._mug_is_in_drawer(mug, self.drawer_position)
        self.mug_has_been_in_drawer |= in_drawer
        self.mug_has_been_in_wrong_drawer |= self._mug_is_in_drawer(
            mug, self.wrong_drawer_position
        )
        if self._gripper_is_open(env) and in_drawer:
            self.mug_has_been_released_in_drawer = True
        self._current_success = self.mug_has_been_released_in_drawer

    def finalize_demo(self, demo_name: str,
                      env: Optional[EnvironmentBase] = None) -> bool:
        if env is not None:
            self.evaluate_step(env)
        return self._record_attempt(
            demo_name, self.mug_has_been_released_in_drawer, {
                "mug_has_been_lifted": bool(self.mug_has_been_lifted),
                "mug_has_been_moved": bool(self.mug_has_been_moved),
                "mug_has_been_in_drawer": bool(self.mug_has_been_in_drawer),
                "mug_has_been_in_wrong_drawer": bool(
                    self.mug_has_been_in_wrong_drawer
                ),
            })


def object_in_box(object_pos, box_bottom_pos,
                  box_size_xy=(0.4, 0.3), box_height: float = 0.2) -> bool:
    """Drill-in-box success geometry (reference:
    tasks/task_definitions/drill_in_box/config/gr1/mdp/terminations.py:30-74,
    called with check_hand_height=False by tasks/task_success.py:18-29):
    object inside the box-bottom-anchored AABB, 1 cm z tolerance below."""
    obj = np.asarray(object_pos, dtype=np.float64)[:3]
    box = np.asarray(box_bottom_pos, dtype=np.float64)[:3]
    half = np.asarray(box_size_xy, dtype=np.float64) / 2.0
    in_xy = bool(np.all(np.abs(obj[:2] - box[:2]) < half))
    in_z = bool(box[2] - 1e-2 < obj[2] < box[2] + box_height)
    return in_xy and in_z


def object_in_drum(object_pos, drum_bottom_pos,
                   drum_radius_m: float = 0.3,
                   drum_height_m: float = 0.7) -> bool:
    """Stick-in-bin success geometry (reference:
    tasks/task_definitions/stick_in_bin/config/gr1/mdp/terminations.py:31-67):
    object within the drum's radius and height band."""
    obj = np.asarray(object_pos, dtype=np.float64)[:3]
    drum = np.asarray(drum_bottom_pos, dtype=np.float64)[:3]
    in_circle = bool(np.linalg.norm(obj[:2] - drum[:2]) <= drum_radius_m)
    in_z = bool(drum[2] - 1e-2 < obj[2] < drum[2] + drum_height_m)
    return in_circle and in_z


class _ObjectInContainerEvaluator(EvaluatorBase):
    """Success = a named object inside a named container, judged from object
    poses. The reference maps these tasks to BasicEvaluator and relies on the
    sim's success term (closed_loop_policy.py:43-48); the geometry below IS
    that term's semantics (tasks/task_success.py), so environments exposing
    object poses get the same judgment without a sim."""

    OBJECT = ""
    CONTAINER = ""

    def _predicate(self, object_pos, container_pos) -> bool:
        raise NotImplementedError

    def _positions(self, env: EnvironmentBase):
        poses = env.get_object_poses()
        missing = [n for n in (self.OBJECT, self.CONTAINER) if n not in poses]
        if missing:
            raise KeyError(
                f"{type(self).__name__} needs object poses {missing} from "
                "the environment (EnvironmentBase.get_object_poses)"
            )
        return (np.asarray(poses[self.OBJECT])[:3],
                np.asarray(poses[self.CONTAINER])[:3])

    def start_demo(self, demo_name: str, env: Optional[EnvironmentBase] = None,
                   retry_idx: int = 0):
        super().start_demo(demo_name, env, retry_idx)
        assert env is not None, "task evaluators need the environment at start"
        obj, _ = self._positions(env)
        self.initial_object_position = obj
        self.object_has_been_lifted = False
        self.object_has_been_moved = False
        self.object_has_been_in_container = False

    def evaluate_step(self, env: EnvironmentBase):
        obj, container = self._positions(env)
        self.object_has_been_lifted |= bool(
            obj[2] - self.initial_object_position[2] > 0.05
        )
        self.object_has_been_moved |= bool(
            np.linalg.norm(obj[:2] - self.initial_object_position[:2]) > 0.05
        )
        if self._predicate(obj, container):
            self.object_has_been_in_container = True
        self._current_success = self.object_has_been_in_container

    def finalize_demo(self, demo_name: str,
                      env: Optional[EnvironmentBase] = None) -> bool:
        if env is not None:
            self.evaluate_step(env)
        return self._record_attempt(
            demo_name, self.object_has_been_in_container, {
                "object_has_been_lifted": bool(self.object_has_been_lifted),
                "object_has_been_moved": bool(self.object_has_been_moved),
            })


class DrillInBoxEvaluator(_ObjectInContainerEvaluator):
    """power_drill released inside open_box (reference scene entity names,
    drill_in_box mdp/terminations.py default SceneEntityCfg args)."""

    OBJECT = "power_drill"
    CONTAINER = "open_box"

    def _predicate(self, object_pos, container_pos) -> bool:
        return object_in_box(object_pos, container_pos)


class StickInBinEvaluator(_ObjectInContainerEvaluator):
    """pick_up_object inside open_drum (reference scene entity names)."""

    OBJECT = "pick_up_object"
    CONTAINER = "open_drum"

    def _predicate(self, object_pos, container_pos) -> bool:
        return object_in_drum(object_pos, container_pos)


def make_evaluator_for_task(task, eval_file_path: Optional[str] = None,
                            env_has_object_state: bool = True,
                            task_params: Optional[Dict] = None
                            ) -> EvaluatorBase:
    """Task -> evaluator map (reference: closed_loop_policy.py:43-48).

    Falls back to BasicEvaluator when the environment exposes no object
    poses (e.g. demo replay, where success is the env's own term).
    ``task_params`` overrides the Isaac-task defaults (e.g. num_cubes /
    cube_side_length for scene-world demos with scaled geometry).
    """
    if not env_has_object_state:
        return BasicEvaluator(eval_file_path)
    task = Tasks(task)
    if task == Tasks.CUBE_STACKING:
        return CubeStackingEvaluator(
            eval_file_path=eval_file_path, **(task_params or {})
        )
    if task == Tasks.MUG_IN_DRAWER:
        return MugInDrawerEvaluator(eval_file_path=eval_file_path)
    # Reference parity note: the reference maps DRILL_IN_BOX/STICK_IN_BIN to
    # BasicEvaluator (sim success term). With object poses available we judge
    # the same geometry framework-side (tasks/task_success.py semantics).
    if task == Tasks.DRILL_IN_BOX:
        return DrillInBoxEvaluator(eval_file_path)
    if task == Tasks.STICK_IN_BIN:
        return StickInBinEvaluator(eval_file_path)
    return BasicEvaluator(eval_file_path)
