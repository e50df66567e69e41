"""Geometry utilities: orthonormalization, SVD rotation fitting, ghost points.

The port's counterpart of ``nvblox_mindmap_tpu/geometry/pointcloud_utils.py``
(upstream ``mindmap/geometry/utils.py:24-161``): the two rotation helpers on
tensors (any device, batched over leading dims), the ghost-point samplers in
numpy with an explicit ``np.random.Generator``, as there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def orthonormalize_by_gram_schmidt(matrix: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt over the columns of (..., 3, 3) matrices."""
    a1, a2, a3 = matrix[..., :, 0], matrix[..., :, 1], matrix[..., :, 2]

    def normalize(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-12)

    b1 = normalize(a1)
    b2 = normalize(a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1)
    b3 = a3 - (b1 * a3).sum(dim=-1, keepdim=True) * b1
    b3 = normalize(b3 - (b2 * a3).sum(dim=-1, keepdim=True) * b2)
    return torch.stack([b1, b2, b3], dim=-1)


def rotation_from_svd(
    points1: torch.Tensor,
    points2: torch.Tensor,
    center1: Optional[torch.Tensor] = None,
    center2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Best-fit rotation R with points1 ~ R @ points2 (Kabsch).

    Args:
        points1, points2: (..., N, 3) corresponding point sets.
        center1, center2: optional (..., 3) centers; default the centroids.

    Returns:
        (..., 3, 3) rotation matrices (det +1 enforced).
    """
    p1 = points1 - (points1.mean(dim=-2, keepdim=True) if center1 is None
                    else center1[..., None, :])
    p2 = points2 - (points2.mean(dim=-2, keepdim=True) if center2 is None
                    else center2[..., None, :])
    H = p2.transpose(-2, -1) @ p1
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-2, -1)
    Ut = U.transpose(-2, -1)
    det = torch.linalg.det(V @ Ut)
    V_fixed = torch.cat([V[..., :2], torch.sign(det)[..., None, None] * V[..., 2:]], dim=-1)
    return V_fixed @ Ut


def sample_ghost_points_grid(bounds, num_points_per_dim: int = 10) -> np.ndarray:
    """Regular grid of points over a (2, 3) AABB -> (n^3, 3)."""
    axes = [
        np.linspace(bounds[0][i], bounds[1][i], num_points_per_dim)
        for i in range(3)
    ]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack(grid, axis=-1).reshape(-1, 3)


def sample_ghost_points_uniform_cube(
    bounds, num_points: int = 1000, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return rng.uniform(bounds[0], bounds[1], size=(num_points, 3))


def sample_ghost_points_uniform_sphere(
    center,
    radius: float,
    bounds,
    num_points: int = 1000,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Rejection-sample uniform points within a sphere intersected with bounds."""
    rng = rng or np.random.default_rng()
    out = np.empty((0, 3))
    center = np.asarray(center)
    while out.shape[0] < num_points:
        pts = sample_ghost_points_uniform_cube(bounds, num_points, rng)
        keep = np.linalg.norm(pts - center, axis=1) < radius
        out = np.concatenate([out, pts[keep]])
    return out[:num_points]
