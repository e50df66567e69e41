"""Mapper configuration constants (the port's own copy of the JAX package's
``nvblox_mindmap_tpu/mapping/constants.py``, upstream
``mindmap/mapping/nvblox_mapper_constants.py``).

- ``Tasks`` and ``get_workspace_bounds``: the workspace box per task, which
  the keypose path normalizes positions to;
- ``MapperId``, ``COMMON_NVBLOX_MAPPER_CFG``, ``TASK_TO_NVBLOX_MAPPER_CFG``:
  the mapper settings shared by every task and those of each task;
- ``MappingConfig``: the frozen, resolved configuration of one mapper, with
  the voxel and block grid shapes it implies.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np


class Tasks(str, enum.Enum):
    CUBE_STACKING = "cube_stacking"
    MUG_IN_DRAWER = "mug_in_drawer"
    DRILL_IN_BOX = "drill_in_box"
    STICK_IN_BIN = "stick_in_bin"


# Scale factor for uint16 depth storage.
DEPTH_SCALE_FACTOR = 1000.0

# Per-voxel feature capacity (upstream builds nvblox with
# NVBLOX_FEATURE_ARRAY_NUM_ELEMENTS=768; here it is a runtime config).
FEATURE_ARRAY_NUM_ELEMENTS = 768


class MapperId:
    STATIC = 0
    DYNAMIC = 1


COMMON_NVBLOX_MAPPER_CFG = {
    "projective_integrator_max_integration_distance_m": 5.0,
    "voxel_size_m": 0.01,
    "unobserved_value": 0.0,
    "required_tensor_shape": (128, 128, 64),
    "upscaled_feature_image_size": (512, 512),
    "feature_mask_border_percent": 5,
    "static_mask_erosion_iterations": 17,
    "dynamic_mask_erosion_iterations": 3,
    "projective_appearance_integrator_measurement_weight": 1.0,
}

TASK_TO_NVBLOX_MAPPER_CFG = {
    Tasks.MUG_IN_DRAWER: {
        "tsdf_decay_factor": 0.999,
        "aabb_min_m": np.array([-0.2, -0.8, -0.2]),
        "aabb_max_m": np.array([0.9, 0.8, 1.0]),
        "min_integration_distance_m": 0.37,
        "use_dynamic_mask": True,
        "dynamic_class_labels": ["robot_arm"],
        "valid_depth_mask_erosion_iterations": 10,
    },
    Tasks.CUBE_STACKING: {
        "tsdf_decay_factor": 0.98,
        "aabb_min_m": np.array([-0.25, -0.65, -0.07]),
        "aabb_max_m": np.array([1.0, 0.62, 0.56]),
        "min_integration_distance_m": 0.10,
        "use_dynamic_mask": True,
        "dynamic_class_labels": ["robot_arm"],
        "valid_depth_mask_erosion_iterations": 20,
    },
    Tasks.DRILL_IN_BOX: {
        "tsdf_decay_factor": 0.98,
        "aabb_min_m": np.array([-0.37, -0.75, -0.13]),
        "aabb_max_m": np.array([0.95, 0.75, 0.65]),
        "min_integration_distance_m": 0.30,
        "use_dynamic_mask": True,
        "dynamic_class_labels": ["robot"],
        "valid_depth_mask_erosion_iterations": 20,
    },
    Tasks.STICK_IN_BIN: {
        "tsdf_decay_factor": 0.98,
        "aabb_min_m": np.array([3.7, 1.5, 0.44]),
        "aabb_max_m": np.array([5.5, 3.2, 1.25]),
        "min_integration_distance_m": 0.30,
        "use_dynamic_mask": True,
        "dynamic_class_labels": ["robot"],
        "valid_depth_mask_erosion_iterations": 20,
    },
}


def get_workspace_bounds(task: Tasks) -> np.ndarray:
    """(2, 3) float32 [min; max] workspace box of a task."""
    cfg = TASK_TO_NVBLOX_MAPPER_CFG[Tasks(task)]
    return np.stack([cfg["aabb_min_m"], cfg["aabb_max_m"]]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Resolved mapper configuration for one task."""

    voxel_size_m: float = 0.01
    aabb_min_m: Tuple[float, float, float] = (-0.37, -0.75, -0.13)
    aabb_max_m: Tuple[float, float, float] = (0.95, 0.75, 0.65)
    tsdf_decay_factor: float = 0.98
    projective_integrator_max_integration_distance_m: float = 5.0
    min_integration_distance_m: float = 0.30
    projective_appearance_integrator_measurement_weight: float = 1.0
    unobserved_value: float = 0.0
    upscaled_feature_image_size: Tuple[int, int] = (512, 512)
    feature_mask_border_percent: int = 5
    static_mask_erosion_iterations: int = 17
    dynamic_mask_erosion_iterations: int = 3
    valid_depth_mask_erosion_iterations: int = 20
    use_dynamic_mask: bool = True
    dynamic_class_labels: Tuple[str, ...] = ()
    feature_dim: int = FEATURE_ARRAY_NUM_ELEMENTS
    # Block-paged feature storage.
    block_size: int = 8
    max_feature_pages: int = 1024
    # TSDF fusion.
    truncation_distance_vox: float = 4.0
    max_tsdf_weight: float = 100.0

    @classmethod
    def for_task(cls, task: Tasks, feature_dim: int = FEATURE_ARRAY_NUM_ELEMENTS,
                 voxel_size_m: float | None = None,
                 max_feature_pages: int = 1024,
                 projective_appearance_integrator_measurement_weight:
                 float | None = None) -> "MappingConfig":
        task_cfg = TASK_TO_NVBLOX_MAPPER_CFG[Tasks(task)]
        common = COMMON_NVBLOX_MAPPER_CFG
        if projective_appearance_integrator_measurement_weight is None:
            projective_appearance_integrator_measurement_weight = common[
                "projective_appearance_integrator_measurement_weight"]
        return cls(
            voxel_size_m=voxel_size_m or common["voxel_size_m"],
            aabb_min_m=tuple(task_cfg["aabb_min_m"]),
            aabb_max_m=tuple(task_cfg["aabb_max_m"]),
            tsdf_decay_factor=task_cfg["tsdf_decay_factor"],
            projective_integrator_max_integration_distance_m=common[
                "projective_integrator_max_integration_distance_m"],
            min_integration_distance_m=task_cfg["min_integration_distance_m"],
            projective_appearance_integrator_measurement_weight=(
                projective_appearance_integrator_measurement_weight),
            unobserved_value=common["unobserved_value"],
            upscaled_feature_image_size=common["upscaled_feature_image_size"],
            feature_mask_border_percent=common["feature_mask_border_percent"],
            static_mask_erosion_iterations=common["static_mask_erosion_iterations"],
            dynamic_mask_erosion_iterations=common["dynamic_mask_erosion_iterations"],
            valid_depth_mask_erosion_iterations=task_cfg[
                "valid_depth_mask_erosion_iterations"],
            use_dynamic_mask=task_cfg["use_dynamic_mask"],
            dynamic_class_labels=tuple(task_cfg["dynamic_class_labels"]),
            feature_dim=feature_dim,
            max_feature_pages=max_feature_pages,
        )

    def scaled_for_image_size(self, image_size: Tuple[int, int]) -> "MappingConfig":
        """Adapt the 512x512-tuned per-pixel constants to a camera resolution.

        The feature image takes the camera's size (per-pixel masks align
        1:1) and the pixel-count erosions scale with the image height, so
        small frames are not eroded to nothing. Identity at 512-high cameras.
        """
        scale = image_size[0] / 512.0

        def _s(n: int) -> int:
            return 0 if n == 0 else max(1, round(n * scale))

        return dataclasses.replace(
            self,
            upscaled_feature_image_size=(int(image_size[0]), int(image_size[1])),
            static_mask_erosion_iterations=_s(self.static_mask_erosion_iterations),
            dynamic_mask_erosion_iterations=_s(self.dynamic_mask_erosion_iterations),
            valid_depth_mask_erosion_iterations=_s(
                self.valid_depth_mask_erosion_iterations),
        )

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        """Voxel grid dims, rounded up to block multiples."""
        dims = []
        for lo, hi in zip(self.aabb_min_m, self.aabb_max_m):
            n = int(np.ceil((hi - lo) / self.voxel_size_m))
            n = ((n + self.block_size - 1) // self.block_size) * self.block_size
            dims.append(n)
        return tuple(dims)

    @property
    def block_grid_shape(self) -> Tuple[int, int, int]:
        gx, gy, gz = self.grid_shape
        b = self.block_size
        return (gx // b, gy // b, gz // b)

    @property
    def truncation_distance_m(self) -> float:
        return self.truncation_distance_vox * self.voxel_size_m
