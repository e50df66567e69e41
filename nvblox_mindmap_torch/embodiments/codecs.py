"""The policy side of the embodiments: how a flat policy-state vector splits
into per-gripper poses and the head yaw.

The port's own copy of the codecs of ``nvblox_mindmap_tpu/embodiments``
(``arm.py:78-80``, ``humanoid.py:104-112``; upstream
``mindmap/embodiments``). The layouts:

- arm: pos3 + quat4 (wxyz) + closedness = 8;
- humanoid: left 8 + right 8 + head yaw = 17.

Keypose detection and robot-state codecs belong to the dataset slice.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from nvblox_mindmap_torch.mapping.constants import Tasks


class EmbodimentType(str, enum.Enum):
    ARM = "arm"
    HUMANOID = "humanoid"


class EmbodimentBase:
    embodiment_type: EmbodimentType
    policy_state_size: int
    num_grippers: int
    predict_head_yaw: bool = False

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


class ArmEmbodiment(EmbodimentBase):
    embodiment_type = EmbodimentType.ARM
    policy_state_size = 8
    num_grippers = 1

    def split_gripper_tensor(self, policy_states: np.ndarray) -> np.ndarray:
        self._check(policy_states)
        return policy_states[..., None, :]


class HumanoidEmbodiment(EmbodimentBase):
    embodiment_type = EmbodimentType.HUMANOID
    policy_state_size = 17
    num_grippers = 2
    predict_head_yaw = True

    def split_gripper_tensor(self, policy_states: np.ndarray) -> np.ndarray:
        self._check(policy_states)
        return np.stack([policy_states[..., :8], policy_states[..., 8:16]], axis=-2)

    def split_head_yaw_tensor(self, policy_states: np.ndarray) -> np.ndarray:
        self._check(policy_states)
        return policy_states[..., 16:17]


HUMANOID_TASKS = (Tasks.DRILL_IN_BOX, Tasks.STICK_IN_BIN)


def make_embodiment_for_task(task: Tasks) -> EmbodimentBase:
    """The arm for cube stacking and mug in drawer, the humanoid for drill
    in box and stick in bin."""
    return HumanoidEmbodiment() if Tasks(task) in HUMANOID_TASKS else ArmEmbodiment()
