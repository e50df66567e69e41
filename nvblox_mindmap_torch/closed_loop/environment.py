"""The sim boundary: the frame contract the policies consume, and the
hermetic environments that satisfy it.

Port of ``nvblox_mindmap_tpu/closed_loop/environment.py``:

- ``CameraFrame``, ``dynamic_mask_from_segmentation``, ``EnvironmentBase``:
  the contract. A deployment implements ``EnvironmentBase`` as a client of
  its simulator or robot;
- ``ReplayEnvironment``: plays a recorded demo back frame by frame (cameras
  and robot states from disk, actions ignored), the datagen / open-loop
  boundary. Its PNGs go through ``data/item_io.decode_png`` (no imageio);
- ``KinematicEnvironment``: a kinematic world where the commanded goal moves
  the end-effector by a bounded step, with simple grasp kinematics: enough
  for the goal-reached / timeout / retry machinery of the runner without a
  simulator.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.goals import slerp
from nvblox_mindmap_torch.data.dataset import DemoDataset
from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType


class CameraFrame:
    """One camera observation (channel-last host arrays)."""

    def __init__(self, rgb, depth, intrinsics, pose7, segmentation=None):
        self.rgb = rgb  # (H, W, 3) float [0,1]
        self.depth = depth  # (H, W) float meters
        self.intrinsics = intrinsics  # (3, 3)
        self.pose7 = pose7  # (7,) pos + quat wxyz
        # (H, W) integer semantic label ids, or None when the source does not
        # record segmentation.
        self.segmentation = segmentation


def dynamic_mask_from_segmentation(
    segmentation: Optional[np.ndarray],
    id_to_class: Dict[int, str],
    dynamic_class_labels,
) -> Optional[np.ndarray]:
    """Boolean (H, W) mask of pixels of any dynamic class (the robot), from
    integer label images and an id -> class map; None without segmentation."""
    if segmentation is None:
        return None
    seg = np.asarray(segmentation)
    mask = np.zeros(seg.shape, dtype=bool)
    wanted = set(dynamic_class_labels)
    for label_id, class_name in id_to_class.items():
        if class_name in wanted:
            mask |= seg == int(label_id)
    return mask


class EnvironmentBase:
    """Abstract environment: the frame contract the policies consume."""

    def reset(self) -> None:
        raise NotImplementedError

    def step(self, goal_policy_state: Optional[np.ndarray]) -> None:
        raise NotImplementedError

    def get_robot_state(self) -> np.ndarray:
        raise NotImplementedError

    def get_policy_state(self) -> np.ndarray:
        """Current policy-state codec (pose + estimated closedness)."""
        raise NotImplementedError

    def get_cameras(self) -> Dict[str, CameraFrame]:
        raise NotImplementedError

    def is_success(self) -> bool:
        raise NotImplementedError

    @property
    def done(self) -> bool:
        return False

    @property
    def semantic_id_to_class(self) -> Dict[int, str]:
        """Label-id -> class-name map for CameraFrame.segmentation images."""
        return {}

    def get_object_poses(self) -> Dict[str, np.ndarray]:
        """World poses (7,) pos + quat wxyz of named scene objects; {} when
        the environment has no object state."""
        return {}


class ReplayEnvironment(EnvironmentBase):
    """Replays a recorded demo dir; actions are ignored."""

    def __init__(self, demo_path: str, embodiment: EmbodimentBase,
                 camera_prefixes: List[str]):
        self.embodiment = embodiment
        self.camera_prefixes = camera_prefixes
        self._demo_path = demo_path
        self.robot_states = DemoDataset.load_robot_states(demo_path)
        self.policy_states = embodiment.policy_states_from_robot_states(
            self.robot_states, use_keyposes=False
        )
        self.num_frames = len(self.robot_states)
        self.t = 0
        # Optional semantic labels map written next to the frames
        # (data/writer.py write_semantic_labels).
        self._id_to_class: Dict[int, str] = {}
        labels_path = os.path.join(demo_path, "semantic_labels.json")
        if os.path.exists(labels_path):
            with open(labels_path) as f:
                self._id_to_class = {
                    int(k): v for k, v in json.load(f).items()
                }

    @property
    def semantic_id_to_class(self) -> Dict[int, str]:
        return self._id_to_class

    def reset(self) -> None:
        self.t = 0

    def step(self, goal_policy_state=None) -> None:
        self.t = min(self.t + 1, self.num_frames - 1)

    @property
    def done(self) -> bool:
        return self.t >= self.num_frames - 1

    def get_robot_state(self) -> np.ndarray:
        return self.robot_states[self.t]

    def get_policy_state(self) -> np.ndarray:
        return self.policy_states[self.t]

    def get_cameras(self) -> Dict[str, CameraFrame]:
        frames = {}
        for prefix in self.camera_prefixes:
            base = os.path.join(self._demo_path, f"{self.t}.{prefix}")
            rgb = np.asarray(decode_png(base + "_rgb.png"), np.float32) / 255.0
            depth = np.asarray(decode_png(base + "_depth.png"), np.float32) / 1000.0
            intr = np.load(base + "_intrinsics.npy").astype(np.float32)
            pose = np.load(base + "_pose.npy").astype(np.float32)
            seg = None
            seg_path = base + "_semantic.png"
            if os.path.exists(seg_path):
                seg = decode_png(seg_path)
            frames[prefix] = CameraFrame(rgb, depth, intr, pose, seg)
        return frames

    def is_success(self) -> bool:
        return self.done


class KinematicEnvironment(EnvironmentBase):
    """Kinematic point-robot world for hermetic closed-loop tests.

    The end-effector moves toward the commanded goal with a bounded step;
    cameras render a synthetic flat scene. Success = the eef having visited
    (within tolerance) all task waypoints.
    """

    def __init__(
        self,
        embodiment: EmbodimentBase,
        initial_state: np.ndarray,
        waypoints: List[np.ndarray],
        max_step_m: float = 0.05,
        waypoint_tolerance_m: float = 0.02,
        image_size: int = 32,
        objects: Optional[Dict[str, np.ndarray]] = None,
        grasp_radius_m: float = 0.05,
        fixed_objects: Optional[List[str]] = None,
        max_head_yaw_step_rad: float = 0.1,
    ):
        self.embodiment = embodiment
        self.initial_state = np.array(initial_state, dtype=np.float32)
        self.waypoints = [np.asarray(w, dtype=np.float32) for w in waypoints]
        self.max_step_m = max_step_m
        self.tol = waypoint_tolerance_m
        self.image_size = image_size
        self.grasp_radius_m = grasp_radius_m
        self.max_head_yaw_step_rad = float(max_head_yaw_step_rad)
        # Named objects with simple grasp kinematics: a closed gripper within
        # grasp_radius attaches the nearest object to the eef; opening
        # releases it in place. Enough state for the task evaluators
        # (cube stacking / mug in drawer) to judge real semantics.
        self.initial_objects = {
            name: self._to_pose7(p) for name, p in (objects or {}).items()
        }
        # Scene furniture (e.g. drawer bottoms) is part of the object-pose
        # contract the evaluators read, but must never be grasped or settled
        # (upstream's analog: articulated/fixed assets vs rigid objects
        # in the Isaac task scenes).
        self.fixed_objects = set(fixed_objects or [])
        unknown = self.fixed_objects - set(self.initial_objects)
        assert not unknown, f"fixed_objects not in objects: {sorted(unknown)}"
        self.reset()

    @staticmethod
    def _to_pose7(p) -> np.ndarray:
        p = np.asarray(p, dtype=np.float32)
        if p.shape == (3,):
            return np.concatenate([p, [1, 0, 0, 0]]).astype(np.float32)
        assert p.shape == (7,), f"object pose must be (3,) or (7,), got {p.shape}"
        return p.copy()

    def reset(self) -> None:
        self.state = np.array(self.initial_state, copy=True)
        self.visited = [False] * len(self.waypoints)
        self.steps = 0
        self.objects = {k: v.copy() for k, v in self.initial_objects.items()}
        # Held objects per gripper slot: {slot_index: object_name}. The arm
        # has one slot (eef state[:3] / closedness [7]); the humanoid has two
        # (left [0:3]/[7], right [8:11]/[15]) so either hand can grasp - the
        # upstream's Right-handed GR1 tasks do the work with hand two.
        self._held: Dict[int, str] = {}

    def _move_pose(self, pose_slice, goal_pose):
        pos = self.state[pose_slice][:3]
        goal_pos = goal_pose[:3]
        delta = goal_pos - pos
        dist = np.linalg.norm(delta)
        if dist > self.max_step_m:
            delta = delta / dist * self.max_step_m
        new_pos = pos + delta
        t = min(1.0, self.max_step_m / max(dist, 1e-9))
        new_quat = slerp(self.state[pose_slice][3:7], goal_pose[3:7], t)
        self.state[pose_slice.start : pose_slice.start + 3] = new_pos
        self.state[pose_slice.start + 3 : pose_slice.start + 7] = new_quat

    def step(self, goal_policy_state: Optional[np.ndarray] = None) -> None:
        self.steps += 1
        if goal_policy_state is None:
            return
        goal = np.asarray(goal_policy_state, dtype=np.float32)
        if self.embodiment.embodiment_type == EmbodimentType.ARM:
            self._move_pose(slice(0, 7), goal[0:7])
            self.state[7] = goal[7]
        else:
            self._move_pose(slice(0, 7), goal[0:7])
            self.state[7] = goal[7]
            self._move_pose(slice(8, 15), goal[8:15])
            self.state[15] = goal[15]
            # Asymptotic head servo (rate-limited proportional control): the
            # yaw approaches the set-point geometrically and never produces
            # an exactly-flat plateau at a direction reversal - real head
            # recordings don't either, and the humanoid head-turn detector
            # (embodiments/humanoid.py get_head_turn_events) keys on a
            # strict sign change of consecutive yaw diffs.
            self.state[16] += np.clip(
                0.8 * (goal[16] - self.state[16]),
                -self.max_head_yaw_step_rad,
                self.max_head_yaw_step_rad,
            )
        # Track waypoint visits (position of the (first) eef).
        for i, w in enumerate(self.waypoints):
            if not self.visited[i] and np.linalg.norm(self.state[:3] - w) < self.tol:
                self.visited[i] = True
        self._update_grasp()

    def _gripper_slots(self) -> List[tuple]:
        """(position slice, closedness index) per gripper in the policy state."""
        if self.embodiment.embodiment_type == EmbodimentType.ARM:
            return [(slice(0, 3), 7)]
        return [(slice(0, 3), 7), (slice(8, 11), 15)]

    def _update_grasp(self) -> None:
        for slot, (pos_slice, closed_idx) in enumerate(self._gripper_slots()):
            eef = self.state[pos_slice]
            closed = float(self.state[closed_idx]) >= 0.5
            taken = set(self._held.values())
            graspable = [
                (n, p) for n, p in self.objects.items()
                if n not in self.fixed_objects and n not in taken
            ]
            if closed and slot not in self._held and graspable:
                name, dist = min(
                    ((n, np.linalg.norm(p[:3] - eef)) for n, p in graspable),
                    key=lambda kv: kv[1],
                )
                if dist < self.grasp_radius_m:
                    self._held[slot] = name
            elif not closed:
                self._held.pop(slot, None)
            if slot in self._held:
                self.objects[self._held[slot]][:3] = eef

    def held_object_names(self) -> List[str]:
        """Names of objects currently attached to a gripper, in slot order.

        The public view of the grasp state: generators and experts that must
        reason about what is in hand (slip sampling, DAgger completion
        planning) read this instead of the private ``_held`` dict.
        """
        return [self._held[s] for s in sorted(self._held)]

    def force_release(
        self, slot: int = 0, position: Optional[np.ndarray] = None
    ) -> Optional[str]:
        """Detach the object held by gripper ``slot`` — a grasp *slip*.

        Optionally teleports the released object to ``position`` (e.g. back
        onto the table, displaced from the gripper). The jaws stay commanded
        closed, so no grasp/release keypose event is recorded; the object is
        simply gone from the hand — the off-nominal state recovery
        demonstrations need (scripted.generate_cube_stacking_recovery_demos).
        The displacement must exceed ``grasp_radius_m`` or the next
        ``_update_grasp`` re-attaches it immediately. Returns the released
        object's name (None if the slot held nothing).
        """
        name = self._held.pop(slot, None)
        if name is not None and position is not None:
            self.objects[name][:3] = np.asarray(position, np.float64)
        return name

    def get_object_poses(self) -> Dict[str, np.ndarray]:
        return {k: v.copy() for k, v in self.objects.items()}

    def get_robot_state(self) -> np.ndarray:
        return np.array(self.state, copy=True)

    def get_policy_state(self) -> np.ndarray:
        """The kinematic world is ideal: robot state == policy state."""
        return np.array(self.state, copy=True)

    def get_cameras(self) -> Dict[str, CameraFrame]:
        H = W = self.image_size
        f = float(W)
        rng = np.random.default_rng(self.steps)
        rgb = rng.uniform(0, 1, size=(H, W, 3)).astype(np.float32)
        depth = np.full((H, W), 1.0, dtype=np.float32)
        intr = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        pose = np.asarray([0, 0, 0.8, 1, 0, 0, 0], np.float32)
        prefix = (
            "wrist"
            if self.embodiment.embodiment_type == EmbodimentType.ARM
            else "pov"
        )
        return {prefix: CameraFrame(rgb, depth, intr, pose)}

    def is_success(self) -> bool:
        # No waypoints configured -> this env has no intrinsic success term
        # (task evaluators judge success from object state instead).
        return bool(self.waypoints) and all(self.visited)
