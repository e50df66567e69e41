"""Host-side (numpy) rotation helpers (wxyz quaternions): the port's own copy
of the parts of ``nvblox_mindmap_tpu/geometry/np_rotations.py`` that the
data pipeline (augmentation, back-projection), the mapper's poses and the
scene world's cameras use.
The arithmetic is the same, so the transforms give the same bits."""
from __future__ import annotations

import numpy as np


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack(
        (
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ),
        axis=-1,
    )


def quat_invert(q: np.ndarray) -> np.ndarray:
    return q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_standardize(q: np.ndarray) -> np.ndarray:
    """Flip sign so the real part is non-negative (pytorch3d convention)."""
    return np.where(q[..., :1] < 0, -q, q)


def quat_apply(q: np.ndarray, pts: np.ndarray) -> np.ndarray:
    zeros = np.zeros(pts.shape[:-1] + (1,), dtype=pts.dtype)
    pq = np.concatenate([zeros, pts], axis=-1)
    out = quat_multiply(quat_multiply(q, pq), quat_invert(q))
    return out[..., 1:]


def euler_xyz_to_quat(rpy: np.ndarray) -> np.ndarray:
    """Intrinsic XYZ euler angles (..., 3) -> wxyz quaternion: q = qx * qy * qz,
    as ``euler_angles_to_matrix(rpy, "XYZ") = Rx @ Ry @ Rz``."""
    half = np.asarray(rpy) * 0.5
    cx, cy, cz = np.cos(half[..., 0]), np.cos(half[..., 1]), np.cos(half[..., 2])
    sx, sy, sz = np.sin(half[..., 0]), np.sin(half[..., 1]), np.sin(half[..., 2])
    qx = np.stack([cx, sx, np.zeros_like(cx), np.zeros_like(cx)], axis=-1)
    qy = np.stack([cy, np.zeros_like(cy), sy, np.zeros_like(cy)], axis=-1)
    qz = np.stack([cz, np.zeros_like(cz), np.zeros_like(cz), sz], axis=-1)
    return quat_multiply(quat_multiply(qx, qy), qz)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    r, i, j, k = np.moveaxis(q, -1, 0)
    two_s = 2.0 / np.sum(q * q, axis=-1)
    o = np.stack(
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
        axis=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """(3, 3) rotation matrix -> wxyz quaternion (Shepperd's method).

    Inverse of quat_to_matrix up to sign; output is standardized (w >= 0).
    """
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        q = np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2.0
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return quat_standardize(q / np.linalg.norm(q))


def pose7_to_matrix(pose7: np.ndarray) -> np.ndarray:
    """(7,) pos + wxyz quaternion -> (4, 4) float32 homogeneous transform."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = quat_to_matrix(np.asarray(pose7[3:7], dtype=np.float64)).astype(np.float32)
    T[:3, 3] = pose7[:3]
    return T
