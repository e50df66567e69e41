"""Workspace bounds per task (the port's own copy of the JAX package's table
in ``nvblox_mindmap_tpu/mapping/constants.py``, upstream
``mindmap/mapping/nvblox_mapper_constants.py``).

Only the axis-aligned workspace box is kept here: the keypose path
normalizes positions to it. The mapper settings arrive with the live-mapping
slice.
"""
from __future__ import annotations

import enum

import numpy as np


class Tasks(str, enum.Enum):
    CUBE_STACKING = "cube_stacking"
    MUG_IN_DRAWER = "mug_in_drawer"
    DRILL_IN_BOX = "drill_in_box"
    STICK_IN_BIN = "stick_in_bin"


# (aabb_min_m, aabb_max_m) per task.
TASK_WORKSPACE_AABB = {
    Tasks.MUG_IN_DRAWER: ((-0.2, -0.8, -0.2), (0.9, 0.8, 1.0)),
    Tasks.CUBE_STACKING: ((-0.25, -0.65, -0.07), (1.0, 0.62, 0.56)),
    Tasks.DRILL_IN_BOX: ((-0.37, -0.75, -0.13), (0.95, 0.75, 0.65)),
    Tasks.STICK_IN_BIN: ((3.7, 1.5, 0.44), (5.5, 3.2, 1.25)),
}


def get_workspace_bounds(task: Tasks) -> np.ndarray:
    """(2, 3) float32 [min; max] workspace box of a task."""
    aabb_min, aabb_max = TASK_WORKSPACE_AABB[Tasks(task)]
    return np.stack([np.asarray(aabb_min), np.asarray(aabb_max)]).astype(np.float32)
