"""Data type routing: the port's own copy of
``nvblox_mindmap_tpu/data/data_types.py`` (upstream
``mindmap/data_loading/data_types.py``)."""
from __future__ import annotations

import enum


class DataType(str, enum.Enum):
    RGBD = "rgbd"
    MESH = "mesh"
    RGBD_AND_MESH = "rgbd_and_mesh"


def includes_rgb(data_type: DataType) -> bool:
    return data_type in (DataType.RGBD, DataType.RGBD_AND_MESH)


def includes_depth_camera(data_type: DataType) -> bool:
    return data_type in (DataType.RGBD, DataType.RGBD_AND_MESH)


def includes_pcd(data_type: DataType) -> bool:
    return data_type in (DataType.RGBD, DataType.RGBD_AND_MESH)


def includes_mesh(data_type: DataType) -> bool:
    return data_type in (DataType.MESH, DataType.RGBD_AND_MESH)


def includes_policy_states(data_type: DataType) -> bool:
    return True


def includes_nvblox(data_type: DataType) -> bool:
    return data_type in (DataType.MESH, DataType.RGBD_AND_MESH)
