"""Host-side (numpy) rotation helpers: the subset of the JAX package's
``nvblox_mindmap_tpu/geometry/np_rotations.py`` behind ``pose7_to_matrix``
(wxyz quaternions)."""
from __future__ import annotations

import numpy as np


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


def pose7_to_matrix(pose7: np.ndarray) -> np.ndarray:
    """(7,) pos + wxyz quaternion -> (4, 4) float32 homogeneous transform."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = quat_to_matrix(np.asarray(pose7[3:7], dtype=np.float64)).astype(np.float32)
    T[:3, 3] = pose7[:3]
    return T
