"""Rotation conversions in torch.

Port of ``nvblox_mindmap_tpu/geometry/rotations.py`` with the same
conventions: quaternions are real-part-first (wxyz); the 6D representation
packs the first two *columns* of the rotation matrix; reconstruction from 6D
is the cross-product Gram-Schmidt (x = norm(b1), z = norm(x cross b2),
y = z cross x); Euler conventions are PyTorch3D's intrinsic letter strings
("XYZ", "ZYZ", ...). All functions broadcast over leading dims.
"""
from __future__ import annotations

import torch


def normalise_quat(x: torch.Tensor) -> torch.Tensor:
    """Normalize quaternions with a 1e-10 clamp on the norm."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-10)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, dim=-1)
    bw, bx, by, bz = torch.unbind(b, dim=-1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack((ow, ox, oy, oz), dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two rotations; result has non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (conjugate)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) of wxyz quaternions; below an angle of 1e-6 the
    sin(a/2)/a ratio is its Taylor series, as in the JAX package."""
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    angles = 2 * half
    small = torch.abs(angles) < 1e-6
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    ratio = torch.where(small, 0.5 - (angles * angles) / 48, torch.sin(half) / safe_angles)
    return q[..., 1:] / ratio


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz) to rotation matrix, shape (..., 3, 3)."""
    r, i, j, k = torch.unbind(q, dim=-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x))."""
    return torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, 1.0)), 0.0)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to quaternion (wxyz).

    Picks the best-conditioned of four algebraically equivalent candidates:
    the largest of the four |q| components, the first on a tie (argmax), with
    the same 0.1 floor on the divisor as the JAX package, so the quaternion's
    sign agrees with it.
    """
    if matrix.shape[-1] != 3 or matrix.shape[-2] != 3:
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}")
    batch_dim = matrix.shape[:-2]
    m = matrix.reshape(batch_dim + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(m, dim=-1)

    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (
        2.0 * torch.clamp(q_abs[..., None], min=0.1)
    )
    # torch.argmax, like jnp.argmax, returns the first index of the maximum.
    best = torch.argmax(q_abs, dim=-1)
    index = best[..., None, None].expand(batch_dim + (1, 4))
    return torch.gather(quat_candidates, -2, index).squeeze(-2)


def _normalize_vector(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(mag, min=eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D (first two matrix columns) to rotation matrix, columns (x, y, z)."""
    x_raw, y_raw = d6[..., 0:3], d6[..., 3:6]
    x = _normalize_vector(x_raw)
    z = _normalize_vector(torch.linalg.cross(x, y_raw, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to 6D: the first two columns, flattened column-major."""
    return matrix[..., :, :2].transpose(-1, -2).reshape(matrix.shape[:-2] + (6,))


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate 3D points by quaternions (broadcasting)."""
    if point.shape[-1] != 3:
        raise ValueError(f"Points are not 3D: {tuple(point.shape)}")
    pq = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(q, pq), quaternion_invert(q))
    return out[..., 1:]


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions of axis-angle vectors (..., 3); below an angle of
    1e-6 the sin(a/2)/a ratio is its Taylor series."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = torch.abs(angles) < 1e-6
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    ratio = torch.where(small, 0.5 - (angles * angles) / 48, torch.sin(half) / safe_angles)
    return torch.cat([torch.cos(half), axis_angle * ratio], dim=-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError("axis must be X, Y or Z")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"Invalid convention {convention}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Euler angles (..., 3) to rotation matrices with an intrinsic convention
    string like "XYZ" (PyTorch3D's: R = R0 @ R1 @ R2)."""
    if euler_angles.shape[-1] != 3:
        raise ValueError("euler_angles must have last dim 3")
    _check_convention(convention)
    mats = [_axis_rotation(axis, euler_angles[..., i]) for i, axis in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    """The first or third Euler angle from a row (``horizontal``) or column
    of the matrix, as PyTorch3D's helper of the same name."""
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """Inverse of ``euler_angles_to_matrix`` (the same convention letters)."""
    _check_convention(convention)
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in [-1, 2] else 1.0
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1, 1))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1, 1))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)
