"""The sim boundary: the frame contract the policies consume.

Port of the interface part of ``nvblox_mindmap_tpu/closed_loop/environment.py``
(``CameraFrame``, ``dynamic_mask_from_segmentation``, ``EnvironmentBase``).
A deployment implements ``EnvironmentBase`` as a client of its simulator or
robot; the JAX package's replay and kinematic worlds satisfy the same
contract, so the port's policy runs in them unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


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
