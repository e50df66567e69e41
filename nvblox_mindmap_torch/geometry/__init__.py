"""The rotation conversions that the JAX package's ``geometry`` exports.

Each is looked up in ``geometry.rotations`` on first use, so a process that
imports only a numpy module of this package (``geometry.np_rotations``, as
the simulator host of the bridge does) does not import torch.
"""
import importlib

__all__ = [
    "axis_angle_to_matrix",
    "axis_angle_to_quaternion",
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "matrix_to_quaternion",
    "matrix_to_rotation_6d",
    "normalise_quat",
    "quaternion_apply",
    "quaternion_invert",
    "quaternion_multiply",
    "quaternion_to_axis_angle",
    "quaternion_to_matrix",
    "rotation_6d_to_matrix",
]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module("nvblox_mindmap_torch.geometry.rotations"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
