"""Goal-reached checks and intermediate-goal interpolation (host numpy).

The port's own copy of ``nvblox_mindmap_tpu/closed_loop/goals.py``
(upstream ``mindmap/embodiments/{arm,humanoid}/embodiment.py`` and
``constants.py``). Policy states are the flat embodiment codecs:
arm (8,) = pos+quat+closedness; humanoid (17,) = Lpose8 + Rpose8 + head_yaw.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType

ARM_GO_TO_NEXT_GOAL_THRESHOLD_M = 0.001
ARM_GO_TO_NEXT_GOAL_THRESHOLD_DEG = 1.0
ARM_GO_TO_NEXT_GOAL_THRESHOLD_GRIPPER_DIFF = 0.2

HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_M = 0.01
HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_DEG = 10.0
HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_GRIPPER_DIFF = 0.2
HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_HEAD_YAW_DEG = 1.0


def quat_angle_deg(q1: np.ndarray, q2: np.ndarray) -> float:
    """Geodesic angle between two wxyz quaternions in degrees."""
    dot = np.abs(np.clip(np.dot(q1, q2), -1.0, 1.0))
    return float(2.0 * np.arccos(dot) * 180.0 / np.pi)


def pose_errors(state_pose7: np.ndarray, goal_pose7: np.ndarray) -> Tuple[float, float]:
    error_m = float(np.linalg.norm(state_pose7[:3] - goal_pose7[:3]))
    error_deg = quat_angle_deg(state_pose7[3:7], goal_pose7[3:7])
    return error_m, error_deg


def is_goal_reached(
    embodiment: EmbodimentBase, current: np.ndarray, goal: np.ndarray,
    is_intermediate_goal: bool = False,
    max_intermediate_distance_m: Optional[float] = None,
) -> bool:
    if is_intermediate_goal and max_intermediate_distance_m is not None:
        # Intermediate goals only avoid big set-point jumps - upstream
        # relaxes pose/gripper checks to half the max intermediate distance
        # on position (humanoid/embodiment.py:337-341) but still ANDs the
        # head-yaw check onto BOTH branches when the embodiment predicts
        # head yaw (humanoid/embodiment.py:386-391).
        threshold = max_intermediate_distance_m * 0.5
        if embodiment.embodiment_type == EmbodimentType.ARM:
            return float(np.linalg.norm(current[:3] - goal[:3])) < threshold
        position_ok = (
            float(np.linalg.norm(current[0:3] - goal[0:3])) < threshold
            and float(np.linalg.norm(current[8:11] - goal[8:11])) < threshold
        )
        if not embodiment.predict_head_yaw:
            return position_ok
        head_err_deg = abs(float(current[16]) - float(goal[16])) * 180.0 / np.pi
        return position_ok and head_err_deg < HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_HEAD_YAW_DEG
    if embodiment.embodiment_type == EmbodimentType.ARM:
        error_m, error_deg = pose_errors(current[:7], goal[:7])
        gripper_diff = abs(float(goal[7]) - float(current[7]))
        return (
            error_m < ARM_GO_TO_NEXT_GOAL_THRESHOLD_M
            and error_deg < ARM_GO_TO_NEXT_GOAL_THRESHOLD_DEG
            and gripper_diff < ARM_GO_TO_NEXT_GOAL_THRESHOLD_GRIPPER_DIFF
        )
    # Humanoid: both hands + head yaw.
    for lo in (0, 8):
        error_m, error_deg = pose_errors(current[lo : lo + 7], goal[lo : lo + 7])
        gripper_diff = abs(float(goal[lo + 7]) - float(current[lo + 7]))
        if not (
            error_m < HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_M
            and error_deg < HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_DEG
            and gripper_diff < HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_GRIPPER_DIFF
        ):
            return False
    if not embodiment.predict_head_yaw:
        return True
    head_err_deg = abs(float(current[16]) - float(goal[16])) * 180.0 / np.pi
    return head_err_deg < HUMANOID_GO_TO_NEXT_GOAL_THRESHOLD_HEAD_YAW_DEG


def slerp(q1: np.ndarray, q2: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation between wxyz quaternions."""
    dot = float(np.dot(q1, q2))
    if dot < 0:
        q2 = -q2
        dot = -dot
    dot = min(dot, 1.0)
    theta = math.acos(dot)
    if theta < 1e-6:
        out = q1 + t * (q2 - q1)
    else:
        s = math.sin(theta)
        out = (math.sin((1 - t) * theta) / s) * q1 + (math.sin(t * theta) / s) * q2
    return out / np.linalg.norm(out)


def add_intermediate_goals(
    embodiment: EmbodimentBase,
    current: np.ndarray,
    goals: List[np.ndarray],
    max_intermediate_distance_m: Optional[float],
) -> Tuple[List[np.ndarray], List[bool]]:
    """Insert SLERP intermediate goals for long humanoid motions.

    (reference humanoid/embodiment.py:237-328); the arm never gets
    intermediate goals.
    """
    if (
        embodiment.embodiment_type == EmbodimentType.ARM
        or max_intermediate_distance_m is None
    ):
        return goals, [False] * len(goals)

    out_goals: List[np.ndarray] = []
    is_intermediate: List[bool] = []
    for goal in goals:
        dist_left = np.linalg.norm(goal[0:3] - current[0:3])
        dist_right = np.linalg.norm(goal[8:11] - current[8:11])
        distance = float(max(dist_left, dist_right))
        if distance <= max_intermediate_distance_m:
            out_goals.append(goal)
            is_intermediate.append(False)
            continue
        n_intermediate = math.floor(distance / max_intermediate_distance_m)
        steps = n_intermediate + 1
        for idx in range(n_intermediate):
            t = (idx + 1) / steps
            g = np.array(goal, copy=True)
            g[0:3] = current[0:3] + t * (goal[0:3] - current[0:3])
            g[3:7] = slerp(current[3:7], goal[3:7], t)
            g[7] = current[7]  # keep current closedness on intermediates
            g[8:11] = current[8:11] + t * (goal[8:11] - current[8:11])
            g[11:15] = slerp(current[11:15], goal[11:15], t)
            g[15] = current[15]
            g[16] = current[16] + t * (goal[16] - current[16])
            out_goals.append(g)
            is_intermediate.append(True)
        out_goals.append(goal)
        is_intermediate.append(False)
    return out_goals, is_intermediate
