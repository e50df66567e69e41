"""Franka arm embodiment: the port's own copy of
``nvblox_mindmap_tpu/embodiments/arm.py`` (upstream
``mindmap/embodiments/arm/*``).

State layouts (upstream's codecs):
- robot state  (9,):  eef pos (3) + eef quat wxyz (4) + gripper jaws (2)
- policy state (8,):  eef pos (3) + eef quat wxyz (4) + closedness (1)
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from nvblox_mindmap_torch.data.keyposes import (
    KeyposeDetectionMode,
    combine_indices,
    ensure_first_and_last_frames_are_keyposes,
    get_extra_keypose_indices_around_intervals,
    get_grasp_events,
    get_highest_z_between_grasps,
    get_highest_z_of_vertical_motion,
    intervals_to_indices,
)
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType

# Gripper jaw position when fully open; closed as soon as not fully open.
GRIPPER_OPEN_THRESHOLD = 0.04 - 1e-4

WRIST_ITEMS = {
    "rgb": "wrist_rgb.png",
    "depth": "wrist_depth.png",
    "pose": "wrist_pose.npy",
    "intrinsics": "wrist_intrinsics.npy",
}
TABLE_ITEMS = {
    "rgb": "table_rgb.png",
    "depth": "table_depth.png",
    "pose": "table_pose.npy",
    "intrinsics": "table_intrinsics.npy",
}


def is_gripper_closed(jaws: np.ndarray) -> np.ndarray:
    """(..., 2) jaw positions -> (...,) bool closed."""
    jaws = np.asarray(jaws)
    return (jaws[..., 0] < GRIPPER_OPEN_THRESHOLD) & (
        jaws[..., 1] < GRIPPER_OPEN_THRESHOLD
    )


def is_gripper_open(jaws: np.ndarray) -> bool:
    return not bool(is_gripper_closed(jaws))


class ArmEmbodiment(EmbodimentBase):
    embodiment_type = EmbodimentType.ARM
    robot_state_size = 9
    policy_state_size = 8
    num_grippers = 1
    predict_head_yaw = False

    gripper_speed_threshold = 0.0025

    # --- codecs --------------------------------------------------------------
    def policy_states_from_robot_states(
        self, robot_states: np.ndarray, use_keyposes: bool = True
    ) -> np.ndarray:
        robot_states = np.asarray(robot_states)
        assert robot_states.ndim == 2 and robot_states.shape[1] == 9
        if use_keyposes:
            _, gripper_open = self.get_grasp_events(robot_states)
            closedness = np.logical_not(gripper_open.astype(bool))
        else:
            closedness = is_gripper_closed(robot_states[:, 7:9])
        return np.concatenate(
            [robot_states[:, :7], closedness.astype(np.float32)[:, None]], axis=1
        ).astype(np.float32)

    def split_gripper_tensor(self, policy_states: np.ndarray) -> np.ndarray:
        self._check(policy_states)
        return policy_states[..., None, :]

    # --- keyposes ------------------------------------------------------------
    def get_grasp_events(self, robot_states: np.ndarray):
        return get_grasp_events(
            gripper_pos=robot_states[:, 7:9],
            gripper_speed_threshold=self.gripper_speed_threshold,
            is_gripper_open=is_gripper_open,
        )

    def extract_keypose_indices(
        self,
        robot_states: np.ndarray,
        extra_keyposes_around_grasp_events: Sequence[int],
        keypose_detection_mode: KeyposeDetectionMode,
    ) -> np.ndarray:
        robot_states = np.asarray(robot_states)
        if len(robot_states) == 1:
            return np.asarray([0])
        eef_pos = robot_states[:, :3]
        grasp_intervals, _ = self.get_grasp_events(robot_states)

        if keypose_detection_mode == KeyposeDetectionMode.HIGHEST_Z_BETWEEN_GRASP:
            maxz = get_highest_z_between_grasps(grasp_intervals, eef_pos)
        elif keypose_detection_mode == KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION:
            # min_vertical_diff_m disabled for the arm (upstream
            # arm/keypose_estimation.py:122-130).
            maxz, _ = get_highest_z_of_vertical_motion(
                grasp_intervals, eef_pos, min_vertical_diff_m=None
            )
        else:
            raise NotImplementedError(
                f"Keypose detection mode not implemented for arm: "
                f"{keypose_detection_mode}"
            )

        extra = get_extra_keypose_indices_around_intervals(
            grasp_intervals, extra_keyposes_around_grasp_events, len(robot_states)
        )
        keyposes = combine_indices(intervals_to_indices(grasp_intervals), maxz, extra)
        return ensure_first_and_last_frames_are_keyposes(keyposes, len(robot_states))

    # --- dataset items -------------------------------------------------------
    def get_camera_item_names_by_encoding_method(
        self, add_external_cam: bool
    ) -> Dict[str, List[str]]:
        items = {
            "rgb": [WRIST_ITEMS["rgb"]],
            "depth": [
                WRIST_ITEMS["depth"],
                WRIST_ITEMS["pose"],
                WRIST_ITEMS["intrinsics"],
            ],
        }
        if add_external_cam:
            items["rgb"].append(TABLE_ITEMS["rgb"])
            items["depth"].extend(
                [TABLE_ITEMS["depth"], TABLE_ITEMS["pose"], TABLE_ITEMS["intrinsics"]]
            )
        return items
