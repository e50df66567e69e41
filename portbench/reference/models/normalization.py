"""Workspace normalization and rotation re-parametrization (torch).

Port of ``nvblox_mindmap_tpu/models/normalization.py``:

- Positions (gripper poses, mesh vertices, point clouds) are affinely
  mapped from the workspace AABB to [-1, 1]; a validity mask marks points
  inside the bounds.
- Trajectory rotations arrive as quaternions (wxyz or xyzw per config) and
  are converted to the continuous 6D representation (first two
  rotation-matrix columns) for diffusion; openness logits get a sigmoid on
  unnormalize.

Trajectory layout: (..., 3 pos + 4 quat [+ extras]) in, (..., 3 + 6
[+ extras]) out.

Intentional divergence kept from the JAX package: the upstream
unnormalize_trajectory, called with its production default
rotation_parametrization "6D_from_query", L2-normalizes dims 3:7 - the first
FOUR of the six 6D coords - before Gram-Schmidt, skewing the second basis
vector. Here, as in the JAX package, every "6D*" string gets the clean "6D"
semantics.
"""
from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.geometry.rotations import (
    matrix_to_quaternion,
    matrix_to_rotation_6d,
    normalise_quat,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)


def normalize_pos(
    pos: torch.Tensor, workspace_bounds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale positions (..., 3) into [-1, 1] over the (2, 3) [min; max] AABB.

    Returns (scaled positions, (...,) bool in-bounds mask).
    """
    pos_min = workspace_bounds[0].to(pos.dtype)
    pos_max = workspace_bounds[1].to(pos.dtype)
    valid = torch.all((pos >= pos_min) & (pos <= pos_max), dim=-1)
    return (pos - pos_min) / (pos_max - pos_min) * 2.0 - 1.0, valid


def normalize_pointcloud(
    pcd: torch.Tensor, workspace_bounds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-last point clouds (..., H, W, 3) -> normalized + in-bounds mask."""
    return normalize_pos(pcd, workspace_bounds)


def unnormalize_pos(pos: torch.Tensor, workspace_bounds: torch.Tensor) -> torch.Tensor:
    pos_min = workspace_bounds[0].to(pos.dtype)
    pos_max = workspace_bounds[1].to(pos.dtype)
    return (pos + 1.0) / 2.0 * (pos_max - pos_min) + pos_min


def convert_rot(
    signal: torch.Tensor,
    rotation_parametrization: str = "6D",
    quaternion_format: str = "wxyz",
) -> torch.Tensor:
    """Quaternion pose signal (..., 3 + 4 [+ extras]) -> (..., 3 + 6 [+ extras])."""
    quat = normalise_quat(signal[..., 3:7])
    if "6D" not in rotation_parametrization:
        return torch.cat([signal[..., :3], quat, signal[..., 7:]], dim=-1)
    if quaternion_format == "xyzw":
        quat = quat[..., (3, 0, 1, 2)]
    rot_6d = matrix_to_rotation_6d(quaternion_to_matrix(quat))
    return torch.cat([signal[..., :3], rot_6d, signal[..., 7:]], dim=-1)


def unconvert_rot(
    signal: torch.Tensor,
    rotation_parametrization: str = "6D",
    quaternion_format: str = "wxyz",
) -> torch.Tensor:
    """6D rotation signal -> quaternion pose signal (inverse of convert_rot)."""
    if "6D" not in rotation_parametrization:
        return signal
    quat = matrix_to_quaternion(rotation_6d_to_matrix(signal[..., 3:9]))
    if quaternion_format == "xyzw":
        quat = quat[..., (1, 2, 3, 0)]
    return torch.cat([signal[..., :3], quat, signal[..., 9:]], dim=-1)


def normalize_trajectory(
    trajectory: torch.Tensor,
    workspace_bounds: torch.Tensor,
    rotation_parametrization: str = "6D",
    quaternion_format: str = "wxyz",
) -> torch.Tensor:
    """Pose trajectory (..., 7) -> normalized (..., 9)."""
    if trajectory.shape[-1] != 7:
        raise ValueError(f"expected (..., 7) poses, got {tuple(trajectory.shape)}")
    pos, _ = normalize_pos(trajectory[..., :3], workspace_bounds)
    return convert_rot(
        torch.cat([pos, trajectory[..., 3:]], dim=-1),
        rotation_parametrization,
        quaternion_format,
    )


def unnormalize_trajectory(
    trajectory: torch.Tensor,
    workspace_bounds: torch.Tensor,
    rotation_parametrization: str = "6D",
    quaternion_format: str = "wxyz",
) -> torch.Tensor:
    """Normalized (..., 9 [+ openness]) -> pose (..., 7 [+ openness prob])."""
    if "6D" not in rotation_parametrization:
        quat = normalise_quat(trajectory[..., 3:7])
        trajectory = torch.cat(
            [trajectory[..., :3], quat, trajectory[..., 7:]], dim=-1
        )
    out = unconvert_rot(trajectory, rotation_parametrization, quaternion_format)
    pos = unnormalize_pos(out[..., :3], workspace_bounds)
    rest = out[..., 3:]
    if rest.shape[-1] > 4:
        # Openness logits -> probability.
        openness = torch.sigmoid(rest[..., 4:5])
        rest = torch.cat([rest[..., :4], openness, rest[..., 5:]], dim=-1)
    return torch.cat([pos, rest], dim=-1)
