"""Embodiment abstraction (array-centric, host-side numpy).

The port's own copy of ``nvblox_mindmap_tpu/embodiments/base.py`` (upstream
``mindmap/embodiments/embodiment_base.py`` and ``state_base.py``):
embodiments work on stacked states, (N, robot_state_size) robot states and
(N, policy_state_size) policy states, in upstream's ``to_tensor()`` layout,
so datasets are interchangeable. One class per embodiment serves both the
data pipeline (robot state -> policy state, keypose estimators, camera item
names) and the policy (``split_gripper_tensor``, ``split_head_yaw_tensor``).
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

import numpy as np


class EmbodimentType(str, enum.Enum):
    ARM = "arm"
    HUMANOID = "humanoid"


class EmbodimentBase:
    """Base class; subclasses define codecs, keyposes and camera items."""

    embodiment_type: EmbodimentType
    robot_state_size: int
    policy_state_size: int
    num_grippers: int
    predict_head_yaw: bool = False

    # --- policy state codecs -------------------------------------------------
    def policy_states_from_robot_states(
        self, robot_states: np.ndarray, use_keyposes: bool = True
    ) -> np.ndarray:
        """(N, robot_state_size) -> (N, policy_state_size)."""
        raise NotImplementedError

    def split_gripper_tensor(self, policy_states: np.ndarray) -> np.ndarray:
        """(B, T, policy_state_size) -> (B, T, num_grippers, 8)."""
        raise NotImplementedError

    def split_head_yaw_tensor(self, policy_states: np.ndarray) -> Optional[np.ndarray]:
        """(B, T, policy_state_size) -> (B, T, 1) or None."""
        return None

    def _check(self, policy_states: np.ndarray) -> None:
        if policy_states.shape[-1] != self.policy_state_size:
            raise ValueError(f"{self.embodiment_type.value} policy states are "
                             f"{self.policy_state_size}-d, got {policy_states.shape}")

    # --- keyposes ------------------------------------------------------------
    def extract_keypose_indices(
        self,
        robot_states: np.ndarray,
        extra_keyposes_around_grasp_events: Sequence[int],
        keypose_detection_mode,
    ) -> np.ndarray:
        raise NotImplementedError

    # --- dataset items -------------------------------------------------------
    def get_camera_item_names_by_encoding_method(
        self, add_external_cam: bool
    ) -> Dict[str, List[str]]:
        raise NotImplementedError


class DelayBasedGripperStateEstimator:
    """Estimates the achieved gripper state from commands with a fixed delay
    (upstream ``mindmap/embodiments/delay_based_estimator.py``): the commanded
    closedness takes ``steps_commanded_to_take_affect`` update calls to be
    reflected in the estimated state."""

    def __init__(self, initial_state: bool, steps_commanded_to_take_affect: int = 10):
        self._state = bool(initial_state)
        self._delay = steps_commanded_to_take_affect
        self._last_command = None
        self._steps_commanded = 0

    def update(self, last_command: Optional[float]):
        if last_command is None:
            return
        commanded = bool(last_command > 0.5)
        if self._last_command is None:
            self._last_command = commanded
            return
        if commanded == self._last_command:
            self._steps_commanded += 1
        else:
            self._steps_commanded = 0
        self._last_command = commanded
        if self._steps_commanded > self._delay:
            self._state = commanded

    def get_state(self) -> bool:
        return self._state
