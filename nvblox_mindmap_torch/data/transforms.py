"""Per-sample transforms for the input pipeline (host-side numpy).

The port's own copy of ``nvblox_mindmap_tpu/data/transforms.py`` (upstream
``mindmap/data_loading/sample_transformer.py``): the same numpy draws in the
same order, so a seed gives the same bits in both packages. Transforms are
stateful where a single random draw must apply to every item of one sample
(GeometryAugmentor); ``reset()`` re-draws. All randomness flows through a
numpy Generator so the pipeline is reproducible and per-process shardable.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from nvblox_mindmap_torch.data.vertex_sampling import (
    VertexSamplingMethod,
    sample_to_n_vertices,
)
from nvblox_mindmap_torch.geometry.np_rotations import (
    quat_standardize,
    euler_xyz_to_quat,
    quat_apply,
    quat_multiply,
)

from nvblox_mindmap_torch.mapping.constants import DEPTH_SCALE_FACTOR  # uint16 mm


class SampleTransformer:
    def reset(self):
        pass

    def __call__(self, sample):
        raise NotImplementedError


class RgbTransformer(SampleTransformer):
    """uint8 [0,255] HWC -> float32 [0,1] HWC (channel-last stays native)."""

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return np.asarray(image, dtype=np.float32) / 255.0


class DepthTransformer(SampleTransformer):
    """uint16 millimeters -> float32 meters."""

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return np.asarray(image, dtype=np.float32) / DEPTH_SCALE_FACTOR


def apply_transform_to_sample(
    sample: np.ndarray, translation: np.ndarray, rotation_quat: np.ndarray
) -> np.ndarray:
    """SE3-transform points (..., 3), poses (..., 8: pos+quat+gripper), or
    humanoid policy states (..., 17: two 8-dim gripper poses + head yaw).

    Upstream supports only (3, 8) (sample_transformer.py:264); the
    17-dim extension transforms both hand poses and adds the transform's own
    yaw to the head-yaw channel so augmentation stays usable for the
    dual-gripper embodiment.
    """
    assert sample.shape[-1] in (3, 8, 17)
    dtype = sample.dtype
    if sample.shape[-1] == 17:
        left = apply_transform_to_sample(
            sample[..., :8], translation, rotation_quat
        )
        right = apply_transform_to_sample(
            sample[..., 8:16], translation, rotation_quat
        )
        # Rotating the world by yaw(q) turns the head by the same yaw.
        # Supports a single (4,) quat or per-row (n, 4) quats (noise mode).
        q = np.asarray(rotation_quat)
        w, x, y, z = np.moveaxis(q, -1, 0)
        dyaw = np.asarray(
            np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
        )[..., None]
        yaw = sample[..., 16:17] + dyaw
        yaw = np.mod(yaw + np.pi, 2 * np.pi) - np.pi
        return np.concatenate([left, right, yaw], axis=-1).astype(dtype)
    pos = quat_apply(rotation_quat, sample[..., :3]) + translation
    if sample.shape[-1] == 8:
        # Standardized (non-negative w), as upstream's pytorch3d
        # quaternion_multiply.
        quat = quat_standardize(quat_multiply(rotation_quat, sample[..., 3:7]))
        out = np.concatenate([pos, quat, sample[..., 7:]], axis=-1)
    else:
        out = pos
    return out.astype(dtype)


class GeometryAugmentor(SampleTransformer):
    """One uniform random SE3 per sample, shared across all its items."""

    def __init__(
        self,
        random_translation_range_m: Tuple[List[float], List[float]],
        random_rpy_range_deg: Tuple[List[float], List[float]],
        rng: Optional[np.random.Generator] = None,
    ):
        self._t_range = random_translation_range_m
        self._rpy_range = random_rpy_range_deg
        self._rng = rng or np.random.default_rng()
        self._translation = None
        self._quat = None
        self.reset()

    def reset(self):
        lo_t, hi_t = np.asarray(self._t_range[0]), np.asarray(self._t_range[1])
        self._translation = self._rng.uniform(lo_t, hi_t)
        lo_r, hi_r = np.asarray(self._rpy_range[0]), np.asarray(self._rpy_range[1])
        rpy = np.deg2rad(self._rng.uniform(lo_r, hi_r))
        self._quat = euler_xyz_to_quat(rpy)

    def __call__(self, sample):
        tensor = sample["vertices"] if isinstance(sample, dict) else sample
        tensor = apply_transform_to_sample(tensor, self._translation, self._quat)
        if isinstance(sample, dict):
            sample["vertices"] = tensor
            return sample
        return tensor


class GeometryNoiser(SampleTransformer):
    """Independent Gaussian SE3 noise per element (row)."""

    def __init__(
        self,
        pos_stddev_m: float,
        rot_stddev_deg: float,
        rng: Optional[np.random.Generator] = None,
    ):
        self._pos_std = pos_stddev_m
        self._rot_std_rad = np.deg2rad(rot_stddev_deg)
        self._rng = rng or np.random.default_rng()

    def __call__(self, sample):
        tensor = sample["vertices"] if isinstance(sample, dict) else sample
        n = tensor.shape[0]
        translation = self._rng.normal(0.0, self._pos_std, size=(n, 3))
        rpy = self._rng.normal(0.0, self._rot_std_rad, size=(n, 3))
        quat = euler_xyz_to_quat(rpy)
        tensor = apply_transform_to_sample(tensor, translation, quat)
        if isinstance(sample, dict):
            sample["vertices"] = tensor
            return sample
        return tensor


class VertexSampler(SampleTransformer):
    """Bring a vertex dict to a fixed vertex count with a validity mask."""

    def __init__(
        self,
        desired_num_vertices: Optional[int],
        method: VertexSamplingMethod,
        rng: Optional[np.random.Generator] = None,
    ):
        assert isinstance(method, VertexSamplingMethod)
        if method != VertexSamplingMethod.NONE:
            assert desired_num_vertices and desired_num_vertices > 0
        self.desired_num_vertices = desired_num_vertices
        self.method = method
        self._rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        (
            sample["vertices"],
            sample["features"],
            sample["vertices_valid_mask"],
        ) = sample_to_n_vertices(
            sample["vertices"],
            sample["features"],
            self.desired_num_vertices,
            self.method,
            self._rng,
        )
        return sample
