"""GR1T2 humanoid sim-side machinery: joint indices, hand retargeting, the
action codec and the policy-state -> action controller.

Port of ``nvblox_mindmap_tpu/embodiments/humanoid_hand.py`` (upstream
``mindmap/embodiments/humanoid/{joint_indices,hand,action,controller}.py``).
These are the pieces a GR1T2 Isaac Lab bridge needs to turn the policy's
17-d states into 37-d joint-level actions: the joint-name -> index layout of
the env's action space, the open and closed hand joint targets, and the
interleaved combined-hands tensor.

Everything here is numpy (no sim, no torch): the sim-host adapter
(``closed_loop/isaaclab_adapter.py``) imports it beside its
``EnvironmentBase``; the embodiment registry does not.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np


class HandSide(enum.Enum):
    LEFT = "left"
    RIGHT = "right"


class _HumanoidJointIndices:
    """Joint name -> index layout of the GR1T2 closed-loop env's action space
    (reference joint_indices.py:19-66; duplicated there from the Isaac Lab
    task config because the constants are needed without the sim running)."""

    joint_names_dict: Dict[str, int] = {
        # arm joints
        "left_shoulder_pitch_joint": 0,
        "right_shoulder_pitch_joint": 1,
        "left_shoulder_roll_joint": 2,
        "right_shoulder_roll_joint": 3,
        "left_shoulder_yaw_joint": 4,
        "right_shoulder_yaw_joint": 5,
        "left_elbow_pitch_joint": 6,
        "right_elbow_pitch_joint": 7,
        "left_wrist_yaw_joint": 8,
        "right_wrist_yaw_joint": 9,
        "left_wrist_roll_joint": 10,
        "right_wrist_roll_joint": 11,
        "left_wrist_pitch_joint": 12,
        "right_wrist_pitch_joint": 13,
        # hand joints
        "L_index_proximal_joint": 14,
        "L_middle_proximal_joint": 15,
        "L_pinky_proximal_joint": 16,
        "L_ring_proximal_joint": 17,
        "L_thumb_proximal_yaw_joint": 18,
        "R_index_proximal_joint": 19,
        "R_middle_proximal_joint": 20,
        "R_pinky_proximal_joint": 21,
        "R_ring_proximal_joint": 22,
        "R_thumb_proximal_yaw_joint": 23,
        "L_index_intermediate_joint": 24,
        "L_middle_intermediate_joint": 25,
        "L_pinky_intermediate_joint": 26,
        "L_ring_intermediate_joint": 27,
        "L_thumb_proximal_pitch_joint": 28,
        "R_index_intermediate_joint": 29,
        "R_middle_intermediate_joint": 30,
        "R_pinky_intermediate_joint": 31,
        "R_ring_intermediate_joint": 32,
        "R_thumb_proximal_pitch_joint": 33,
        "L_thumb_distal_joint": 34,
        "R_thumb_distal_joint": 35,
    }

    def __init__(self):
        self.num_joints_per_hand = len(
            [name for name in self.joint_names_dict if name.startswith("L_")]
        )
        self.hand_joint_name_to_idx_map = self._hand_map()
        self.left_hand_name_to_idx_map = self._hand_map(HandSide.LEFT)
        self.right_hand_name_to_idx_map = self._hand_map(HandSide.RIGHT)
        self.within_hand_joint_name_to_idx_map = self._within_hand_map()
        # Indices of each hand's joints inside the interleaved 22-joint
        # combined-hands tensor (L/R alternate per finger group).
        self.left_joints_in_combined_hands_tensor_indices: List[int] = list(
            self.left_hand_name_to_idx_map.values()
        )
        self.right_joints_in_combined_hands_tensor_indices: List[int] = list(
            self.right_hand_name_to_idx_map.values()
        )

    def _hand_map(self, side: Optional[HandSide] = None) -> Dict[str, int]:
        finger = {
            name: idx for name, idx in self.joint_names_dict.items()
            if name.startswith(("L_", "R_"))
        }
        base = min(finger.values())
        finger = {name: idx - base for name, idx in finger.items()}
        if side is HandSide.LEFT:
            finger = {n: i for n, i in finger.items() if n.startswith("L_")}
        elif side is HandSide.RIGHT:
            finger = {n: i for n, i in finger.items() if n.startswith("R_")}
        return finger

    def _within_hand_map(self) -> Dict[str, int]:
        return {
            name[len("L_"):]: i
            for i, name in enumerate(self._hand_map(HandSide.LEFT))
        }


HumanoidJointIndices = _HumanoidJointIndices()

NUM_HAND_JOINTS = HumanoidJointIndices.num_joints_per_hand  # 11

# Hand closedness threshold on the proximal joints: fully open is 0.0, fully
# closed -1.57; near-open threshold still detects closure around held objects
# (reference hand.py:19-25).
CLOSED_THRESHOLD = -0.4

# Joint-space targets for binary open/close hand commands (radians; the
# within-hand joint order above). Reference controller.py:21-47.
CLOSED_HAND_JOINT_STATES: Dict[str, float] = {
    "index_proximal_joint": -1.35,
    "middle_proximal_joint": -1.57,
    "pinky_proximal_joint": -1.57,
    "ring_proximal_joint": -1.57,
    "thumb_proximal_yaw_joint": -1.57,
    "index_intermediate_joint": 0.35,
    "middle_intermediate_joint": 0.18,
    "pinky_intermediate_joint": -0.60,
    "ring_intermediate_joint": -0.72,
    "thumb_proximal_pitch_joint": 1.11,
    "thumb_distal_joint": -0.24,
}
OPEN_HAND_JOINT_STATES: Dict[str, float] = {
    "index_proximal_joint": -0.00,
    "middle_proximal_joint": 0.00,
    "pinky_proximal_joint": 0.00,
    "ring_proximal_joint": 0.00,
    "thumb_proximal_yaw_joint": -1.57,
    "index_intermediate_joint": 0.00,
    "middle_intermediate_joint": -0.00,
    "pinky_intermediate_joint": 0.00,
    "ring_intermediate_joint": 0.00,
    "thumb_proximal_pitch_joint": 0.0,
    "thumb_distal_joint": 0.43,
}

HUMANOID_CLOSEDNESS_THRESHOLD = 0.5


def get_tensor_of_proximal_joints(
    one_hand_joint_states: np.ndarray,
    excluded_joint_strings: Tuple[str, ...] = ("thumb", "index"),
) -> Tuple[np.ndarray, List[str]]:
    """(N, 11) hand joints -> (N, n_proximal) middle/pinky/ring proximal
    joints + their names (reference hand.py:66-88)."""
    states = np.asarray(one_hand_joint_states)
    assert states.ndim == 2 and states.shape[1] == NUM_HAND_JOINTS
    selected = {
        name: idx
        for name, idx in HumanoidJointIndices.within_hand_joint_name_to_idx_map.items()
        if "proximal" in name and not any(s in name for s in excluded_joint_strings)
    }
    return states[:, list(selected.values())], list(selected)


def is_hand_closed_instantaneous_from_proximal_joint_states(
    proximal_joint_states: np.ndarray,
) -> bool:
    """(n_proximal,) -> closed if ANY proximal joint passed the threshold."""
    prox = np.asarray(proximal_joint_states)
    assert prox.ndim == 1 and prox.shape[0] < NUM_HAND_JOINTS
    return bool(np.any(prox < CLOSED_THRESHOLD))


def is_hand_open_instantaneous_from_proximal_joint_states(
    proximal_joint_states: np.ndarray,
) -> bool:
    return not is_hand_closed_instantaneous_from_proximal_joint_states(
        proximal_joint_states
    )


@dataclasses.dataclass
class HumanoidAction:
    """Joint-level action the GR1T2 env consumes (reference action.py:20-101).

    Layout of ``to_tensor(include_head_yaw=True)`` (37,):
    [L eef pos(3) + quat wxyz(4), R eef pos(3) + quat(4), head yaw(1),
     combined hands(22, interleaved per HumanoidJointIndices)].
    """

    W_t_W_LeftEef: np.ndarray
    q_wxyz_W_LeftEef: np.ndarray
    left_hand_joint_states: np.ndarray
    W_t_W_RightEef: np.ndarray
    q_wxyz_W_RightEef: np.ndarray
    right_hand_joint_states: np.ndarray
    head_yaw_rad: np.ndarray

    def __post_init__(self):
        self.W_t_W_LeftEef = np.asarray(self.W_t_W_LeftEef, np.float32)
        self.q_wxyz_W_LeftEef = np.asarray(self.q_wxyz_W_LeftEef, np.float32)
        self.left_hand_joint_states = np.asarray(
            self.left_hand_joint_states, np.float32
        )
        self.W_t_W_RightEef = np.asarray(self.W_t_W_RightEef, np.float32)
        self.q_wxyz_W_RightEef = np.asarray(self.q_wxyz_W_RightEef, np.float32)
        self.right_hand_joint_states = np.asarray(
            self.right_hand_joint_states, np.float32
        )
        self.head_yaw_rad = np.asarray(self.head_yaw_rad, np.float32)
        assert self.W_t_W_LeftEef.shape == (3,)
        assert self.q_wxyz_W_LeftEef.shape == (4,)
        assert self.left_hand_joint_states.shape == (NUM_HAND_JOINTS,)
        assert self.W_t_W_RightEef.shape == (3,)
        assert self.q_wxyz_W_RightEef.shape == (4,)
        assert self.right_hand_joint_states.shape == (NUM_HAND_JOINTS,)
        assert self.head_yaw_rad.shape == (1,)
        # Wrap into [-pi, pi): the yaw comes from unclamped model regression;
        # a value of e.g. 3.15 must not kill a live episode with an assert.
        self.head_yaw_rad = np.asarray(
            np.mod(self.head_yaw_rad + np.pi, 2 * np.pi) - np.pi, np.float32
        )

    @staticmethod
    def state_size() -> int:
        return 37

    def to_tensor(self, include_head_yaw: bool = True) -> np.ndarray:
        eef = np.concatenate(
            [self.W_t_W_LeftEef, self.q_wxyz_W_LeftEef,
             self.W_t_W_RightEef, self.q_wxyz_W_RightEef]
        )
        combined = np.zeros(2 * NUM_HAND_JOINTS, np.float32)
        combined[HumanoidJointIndices.left_joints_in_combined_hands_tensor_indices] = (
            self.left_hand_joint_states
        )
        combined[HumanoidJointIndices.right_joints_in_combined_hands_tensor_indices] = (
            self.right_hand_joint_states
        )
        parts = [eef]
        if include_head_yaw:
            parts.append(self.head_yaw_rad)
        parts.append(combined)
        out = np.concatenate(parts).astype(np.float32)
        expected = self.state_size() if include_head_yaw else self.state_size() - 1
        assert out.shape == (expected,)
        return out

    @staticmethod
    def from_tensor(tensor: np.ndarray) -> "HumanoidAction":
        """True inverse of ``to_tensor(include_head_yaw=True)``.

        Intentional divergence: the reference's from_tensor (action.py:84-100)
        reads the hands as two contiguous 11-blocks, which does not invert its
        own to_tensor interleaving - its in-code TODO acknowledges the layout
        is wrong. Here the combined-hands tensor is de-interleaved with the
        same index maps to_tensor packs with, so round-trips are exact.
        """
        tensor = np.asarray(tensor, np.float32)
        assert tensor.ndim == 1 and tensor.shape[0] == HumanoidAction.state_size()
        combined = tensor[15:37]
        return HumanoidAction(
            W_t_W_LeftEef=tensor[0:3],
            q_wxyz_W_LeftEef=tensor[3:7],
            W_t_W_RightEef=tensor[7:10],
            q_wxyz_W_RightEef=tensor[10:14],
            head_yaw_rad=tensor[14:15],
            left_hand_joint_states=combined[
                HumanoidJointIndices.left_joints_in_combined_hands_tensor_indices
            ],
            right_hand_joint_states=combined[
                HumanoidJointIndices.right_joints_in_combined_hands_tensor_indices
            ],
        )


class HumanoidController:
    """Policy state (17,) -> HumanoidAction (reference controller.py:50-88):
    binary closedness retargets to the full open/closed hand joint configs."""

    def __init__(self):
        assert list(CLOSED_HAND_JOINT_STATES) == list(
            HumanoidJointIndices.within_hand_joint_name_to_idx_map
        )
        assert list(OPEN_HAND_JOINT_STATES) == list(
            HumanoidJointIndices.within_hand_joint_name_to_idx_map
        )
        self.closed_hand_joint_states = np.asarray(
            list(CLOSED_HAND_JOINT_STATES.values()), np.float32
        )
        self.open_hand_joint_states = np.asarray(
            list(OPEN_HAND_JOINT_STATES.values()), np.float32
        )

    def get_hand_joint_states(self, closedness: float) -> np.ndarray:
        if closedness > HUMANOID_CLOSEDNESS_THRESHOLD:
            return self.closed_hand_joint_states.copy()
        return self.open_hand_joint_states.copy()

    def __call__(self, policy_state: np.ndarray) -> HumanoidAction:
        """policy_state (17,): [L pose7 + closed, R pose7 + closed, head]."""
        state = np.asarray(policy_state, np.float32)
        assert state.shape == (17,)
        return HumanoidAction(
            W_t_W_LeftEef=state[0:3],
            q_wxyz_W_LeftEef=state[3:7],
            left_hand_joint_states=self.get_hand_joint_states(float(state[7])),
            W_t_W_RightEef=state[8:11],
            q_wxyz_W_RightEef=state[11:15],
            right_hand_joint_states=self.get_hand_joint_states(float(state[15])),
            head_yaw_rad=state[16:17],
        )
