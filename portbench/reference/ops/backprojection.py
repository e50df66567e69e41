"""Depth-image backprojection to world-frame point clouds.

Port of ``nvblox_mindmap_tpu/ops/backprojection.py`` (upstream
``mindmap/image_processing/backprojection.py``): pixel grid -> K^-1
unprojection scaled by depth -> extrinsic transform; NaN/inf points become
zero. Camera pose quaternions are wxyz.
"""
from __future__ import annotations

import torch

from portbench.reference.geometry.rotations import quaternion_to_matrix


def pose_to_homo(position: torch.Tensor, quat_wxyz: torch.Tensor) -> torch.Tensor:
    """(B, 3) position + (B, 4) wxyz quaternion -> (B, 4, 4) homogeneous matrix."""
    B = position.shape[0]
    rot = quaternion_to_matrix(quat_wxyz)
    top = torch.cat([rot, position[:, :, None]], dim=-1)  # (B, 3, 4)
    bottom = position.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def backproject_depth(depth: torch.Tensor, intrinsics: torch.Tensor,
                      transform: torch.Tensor) -> torch.Tensor:
    """Backproject a batch of depth images to world points.

    Args:
        depth: (B, H, W) metric depth.
        intrinsics: (B, 3, 3) camera matrices.
        transform: (B, 4, 4) camera-to-world transforms.

    Returns:
        (B, H, W, 3) world-frame points; invalid (nan/inf) values become 0.
    """
    B, H, W = depth.shape
    jj, ii = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device),
        indexing="ij",
    )
    uv1 = torch.stack([ii, jj, torch.ones_like(ii)], dim=-1).reshape(1, H * W, 3)
    k_inv = torch.linalg.inv(intrinsics)  # (B, 3, 3)
    rays = uv1 @ k_inv.transpose(-1, -2)  # (B, HW, 3)
    xyz_cam = depth.reshape(B, H * W, 1) * rays
    rot = transform[:, :3, :3]
    trans = transform[:, :3, 3]
    xyz_world = xyz_cam @ rot.transpose(-1, -2) + trans[:, None, :]
    xyz_world = torch.nan_to_num(xyz_world, nan=0.0, posinf=0.0, neginf=0.0)
    return xyz_world.reshape(B, H, W, 3)


def get_camera_pointcloud(intrinsics: torch.Tensor, depth: torch.Tensor,
                          position: torch.Tensor,
                          orientation_wxyz: torch.Tensor) -> torch.Tensor:
    """World-frame point cloud from depth + camera pose.

    Args:
        intrinsics: (B, 3, 3) or (3, 3).
        depth: (B, H, W) or (H, W).
        position: (B, 3) or (3,).
        orientation_wxyz: (B, 4) or (4,) quaternion.

    Returns:
        (B, H, W, 3) points (batch dim squeezed if the input was unbatched).
    """
    squeeze = depth.dim() == 2
    if squeeze:
        intrinsics, depth = intrinsics[None], depth[None]
        position, orientation_wxyz = position[None], orientation_wxyz[None]
    transform = pose_to_homo(position, orientation_wxyz)
    pcd = backproject_depth(depth, intrinsics, transform)
    return pcd[0] if squeeze else pcd
