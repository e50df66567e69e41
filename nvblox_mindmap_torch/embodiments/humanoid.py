"""GR1T2 humanoid embodiment: the port's own copy of
``nvblox_mindmap_tpu/embodiments/humanoid.py`` (upstream
``mindmap/embodiments/humanoid/*``).

State layouts (upstream's codecs):
- robot state  (37,): L pos(3)+quat(4)+hand joints(11), R pos(3)+quat(4)+
  hand joints(11), head yaw(1)
- policy state (17,): L pos(3)+quat(4)+closedness(1), R likewise, head yaw(1)

Hand closedness uses a hysteresis over the non-thumb/non-index proximal
joints; grasp intervals come from joint-velocity backtracking from
hysteresis transitions, with spurious close-together intervals filtered.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from nvblox_mindmap_torch.data.keyposes import (
    KeyposeDetectionMode,
    combine_indices,
    ensure_first_and_last_frames_are_keyposes,
    get_extra_keypose_indices_around_intervals,
    get_extra_keyposes_between_indices,
    get_highest_z_of_vertical_motion,
    get_previous_keypose,
    has_head_turn_events,
    has_highest_z_of_vertical_motion,
    intervals_to_indices,
    select_indices_between_grasps,
)
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType

NUM_HAND_JOINTS = 11
# Within-hand indices of the "proximal" joints excluding thumb/index
# (middle, pinky, ring proximal), upstream humanoid/hand.py:66-88.
PROXIMAL_JOINT_INDICES = [1, 2, 3]
# Hand closedness hysteresis thresholds (radians; 0 open, -1.57 closed).
CLOSED_THRESHOLD = -0.4
OPEN_THRESHOLD = -0.2
CLOSE_INTERVAL_THRESHOLD = 10

POV_ITEMS = {
    "rgb": "pov_rgb.png",
    "depth": "pov_depth.png",
    "pose": "pov_pose.npy",
    "intrinsics": "pov_intrinsics.npy",
}
EXTERNAL_ITEMS = {
    "rgb": "external_rgb.png",
    "depth": "external_depth.png",
    "pose": "external_pose.npy",
    "intrinsics": "external_intrinsics.npy",
}

# Robot state slices.
_L_POSE = slice(0, 7)
_L_JOINTS = slice(7, 18)
_R_POSE = slice(18, 25)
_R_JOINTS = slice(25, 36)
_HEAD_YAW = slice(36, 37)


def is_hand_closed_instantaneous(proximal: np.ndarray) -> bool:
    return bool(np.any(np.asarray(proximal) < CLOSED_THRESHOLD))


class HumanoidEmbodiment(EmbodimentBase):
    embodiment_type = EmbodimentType.HUMANOID
    robot_state_size = 37
    policy_state_size = 17
    num_grippers = 2
    predict_head_yaw = True

    velocity_threshold = 0.01
    smoothing_kernel_size = 2

    # --- codecs --------------------------------------------------------------
    def policy_states_from_robot_states(
        self, robot_states: np.ndarray, use_keyposes: bool = True
    ) -> np.ndarray:
        robot_states = np.asarray(robot_states)
        assert robot_states.ndim == 2 and robot_states.shape[1] == 37
        left_prox = robot_states[:, _L_JOINTS][:, PROXIMAL_JOINT_INDICES]
        right_prox = robot_states[:, _R_JOINTS][:, PROXIMAL_JOINT_INDICES]
        if use_keyposes:
            _, left_open = self._grasp_events_single_hand(robot_states[:, _L_JOINTS])
            _, right_open = self._grasp_events_single_hand(robot_states[:, _R_JOINTS])
            left_closed = np.logical_not(left_open.astype(bool))
            right_closed = np.logical_not(right_open.astype(bool))
        else:
            left_closed = np.any(left_prox < CLOSED_THRESHOLD, axis=1)
            right_closed = np.any(right_prox < CLOSED_THRESHOLD, axis=1)
        return np.concatenate(
            [
                robot_states[:, _L_POSE],
                left_closed.astype(np.float32)[:, None],
                robot_states[:, _R_POSE],
                right_closed.astype(np.float32)[:, None],
                robot_states[:, _HEAD_YAW],
            ],
            axis=1,
        ).astype(np.float32)

    def split_gripper_tensor(self, policy_states: np.ndarray) -> np.ndarray:
        self._check(policy_states)
        left = policy_states[..., :8]
        right = policy_states[..., 8:16]
        return np.stack([left, right], axis=-2)

    def split_head_yaw_tensor(self, policy_states: np.ndarray) -> np.ndarray:
        self._check(policy_states)
        return policy_states[..., 16:17]

    # --- grasp events --------------------------------------------------------
    def _grasp_events_single_hand(
        self, hand_joint_states: np.ndarray
    ) -> Tuple[List[Tuple[int, int]], np.ndarray]:
        """Hysteresis closedness + velocity-backtracked grasp intervals.

        (upstream humanoid/keypose_estimation.py:276-385)
        """
        assert hand_joint_states.ndim == 2
        assert hand_joint_states.shape[1] == NUM_HAND_JOINTS
        prox = hand_joint_states[:, PROXIMAL_JOINT_INDICES]

        closed = is_hand_closed_instantaneous(prox[0])
        closedness_states = []
        transition_indices = []
        for idx in range(prox.shape[0]):
            if not closed:
                if np.any(prox[idx] < CLOSED_THRESHOLD):
                    closed = True
                    transition_indices.append(idx)
            else:
                if np.all(prox[idx] > OPEN_THRESHOLD):
                    closed = False
                    transition_indices.append(idx)
            closedness_states.append(closed)

        velocities = np.abs(np.diff(prox, axis=0))
        kernel = np.ones(self.smoothing_kernel_size) / self.smoothing_kernel_size
        smoothed = np.stack(
            [np.convolve(velocities[:, i], kernel) for i in range(velocities.shape[1])],
            axis=-1,
        )

        start_indices = []
        for tidx in transition_indices:
            i = tidx
            while i > 0:
                i -= 1
                if np.any(smoothed[i] < self.velocity_threshold):
                    break
            start_indices.append(i)
        intervals = list(zip(start_indices, transition_indices))
        gripper_open = (~np.asarray(closedness_states, dtype=bool)).astype(int)
        intervals = self._filter_close_intervals(intervals, len(hand_joint_states))
        return intervals, gripper_open

    @staticmethod
    def _are_close_intervals(a, b, thr=CLOSE_INTERVAL_THRESHOLD) -> bool:
        return (
            abs(a[0] - b[0]) <= thr
            or abs(a[1] - b[0]) <= thr
            or abs(a[0] - b[1]) <= thr
            or abs(a[1] - b[1]) <= thr
        )

    def _filter_close_intervals(self, intervals, demo_length):
        # As upstream (humanoid/keypose_estimation.py:387-425), the
        # demo-boundary checks live inside the pairwise loop, so a
        # single-interval list is never boundary-filtered.
        filtered = []
        for i, cur in enumerate(intervals):
            close = False
            for j, other in enumerate(intervals):
                if i == j:
                    continue
                if (
                    self._are_close_intervals(cur, other)
                    or cur[0] <= CLOSE_INTERVAL_THRESHOLD
                    or cur[1] >= demo_length - CLOSE_INTERVAL_THRESHOLD
                ):
                    close = True
            if not close:
                filtered.append(cur)
        return filtered

    def get_grasp_events(self, robot_states: np.ndarray):
        left = self._grasp_events_single_hand(robot_states[:, _L_JOINTS])
        right = self._grasp_events_single_hand(robot_states[:, _R_JOINTS])
        return left, right

    # --- head turns ----------------------------------------------------------
    def get_head_turn_events(
        self,
        head_yaw: np.ndarray,
        keypose_indices: List[int],
        min_yaw_diff_rad: float = 45.0 * np.pi / 180.0,
    ) -> List[int]:
        """Indices where head rotation reverses direction by >= 45 degrees."""
        yaw_diffs = np.diff(head_yaw)
        sign_change = (yaw_diffs[:-1] * yaw_diffs[1:]) < 0
        candidates = np.where(sign_change)[0] + 1
        head_turns: List[int] = []
        for idx in candidates:
            prev = get_previous_keypose(head_turns + list(keypose_indices), idx)
            if abs(head_yaw[idx] - head_yaw[prev]) > min_yaw_diff_rad:
                head_turns.append(int(idx))
        return head_turns

    # --- keyposes ------------------------------------------------------------
    def extract_keypose_indices(
        self,
        robot_states: np.ndarray,
        extra_keyposes_around_grasp_events: Sequence[int],
        keypose_detection_mode: KeyposeDetectionMode,
    ) -> np.ndarray:
        robot_states = np.asarray(robot_states)
        (left_intervals, _), (right_intervals, _) = self.get_grasp_events(robot_states)
        left_pos = robot_states[:, 0:3]
        right_pos = robot_states[:, 18:21]

        keyposes = np.asarray([], dtype=np.int32)
        for intervals, eef_pos in (
            (left_intervals, left_pos),
            (right_intervals, right_pos),
        ):
            vertical, extra_vertical = [], []
            if has_highest_z_of_vertical_motion(keypose_detection_mode):
                vertical, _ = get_highest_z_of_vertical_motion(intervals, eef_pos)
                if intervals:
                    vertical = select_indices_between_grasps(vertical, intervals)
                extra_vertical = get_extra_keyposes_between_indices(
                    vertical, min_interval_distance=10, fractions=[0.5]
                )
            elif keypose_detection_mode not in (
                KeyposeDetectionMode.NONE,
            ):
                raise NotImplementedError(
                    f"{keypose_detection_mode} not implemented for humanoid"
                )
            grasp_keyposes = intervals_to_indices(intervals)
            extra_grasp = get_extra_keypose_indices_around_intervals(
                intervals, extra_keyposes_around_grasp_events, len(robot_states)
            )
            keyposes = combine_indices(
                keyposes, grasp_keyposes, extra_grasp, vertical, extra_vertical
            )

        if has_head_turn_events(keypose_detection_mode):
            head_turns = self.get_head_turn_events(
                robot_states[:, 36], keyposes.tolist()
            )
            keyposes = combine_indices(keyposes, head_turns)

        return ensure_first_and_last_frames_are_keyposes(keyposes, len(robot_states))

    # --- dataset items -------------------------------------------------------
    def get_camera_item_names_by_encoding_method(
        self, add_external_cam: bool
    ) -> Dict[str, List[str]]:
        items = {
            "rgb": [POV_ITEMS["rgb"]],
            "depth": [
                POV_ITEMS["depth"],
                POV_ITEMS["pose"],
                POV_ITEMS["intrinsics"],
            ],
        }
        if add_external_cam:
            items["rgb"].append(EXTERNAL_ITEMS["rgb"])
            items["depth"].extend(
                [
                    EXTERNAL_ITEMS["depth"],
                    EXTERNAL_ITEMS["pose"],
                    EXTERNAL_ITEMS["intrinsics"],
                ]
            )
        return items
