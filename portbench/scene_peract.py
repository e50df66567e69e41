"""Inputs of the PerAct prediction cell, made from the seed on the device:
keyframes of a table-top box world as RLBench's four cameras see it, and one
instruction per PerAct task.

- ``keyframes``: each keyframe is a table with four boxes of seeded sizes,
  places and colours in a closed room, a gripper pose over the table with
  the two poses before it (position, xyzw quaternion, openness), and the
  four cameras' views of it (``CAMERAS``: two shoulders and the front
  camera fixed, the wrist camera riding on the gripper), ray cast with
  ``scene_humanoid.render_frames`` as uint8 RGB (with seeded sensor noise)
  and float32 world points. The room lies outside the workspace, so its
  points fall outside the bounds that the model keeps.
- ``instructions``: (1, T, 512) float32 token features, normal draws in
  place of CLIP's text features.

Everything the model reads is returned as host arrays in the batch layout of
the open-loop app's inference function.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import scene, scene_humanoid

CAMERAS = ("left_shoulder", "right_shoulder", "wrist", "front")
TABLE_Z = 0.752  # RLBench's table top
# Eyes and targets of the fixed cameras (RLBench's layout: behind the robot's
# shoulders and in front of the table).
FIXED_CAMERAS = {
    "left_shoulder": ((-0.15, 0.45, 1.55), (0.35, 0.0, TABLE_Z)),
    "right_shoulder": ((-0.15, -0.45, 1.55), (0.35, 0.0, TABLE_Z)),
    "front": ((1.35, 0.0, 1.58), (0.2, 0.0, TABLE_Z)),
}
ROOM = (
    ((-2.5, -2.5, -0.05), (2.5, 2.5, 0.0), (0.45, 0.45, 0.42), 10),  # floor
    ((-2.5, -2.5, 3.0), (2.5, 2.5, 3.05), (0.85, 0.85, 0.85), 10),  # ceiling
    ((-2.55, -2.5, 0.0), (-2.5, 2.5, 3.0), (0.70, 0.72, 0.75), 10),
    ((2.5, -2.5, 0.0), (2.55, 2.5, 3.0), (0.70, 0.72, 0.75), 10),
    ((-2.5, -2.55, 0.0), (2.5, -2.5, 3.0), (0.66, 0.70, 0.72), 10),
    ((-2.5, 2.5, 0.0), (2.5, 2.55, 3.0), (0.66, 0.70, 0.72), 10),
)
TABLE = ((-0.45, -0.75, TABLE_Z - 0.04), (0.95, 0.75, TABLE_Z), (0.55, 0.45, 0.35), 1)
BOXES = 4
RGB_NOISE = 0.02  # std of the sensor noise on [0, 1] colours


def gripper_quat_xyzw(yaw: float) -> np.ndarray:
    """A gripper pointing down (a half turn about x) turned by ``yaw`` about
    the world's z, as an xyzw quaternion."""
    return np.asarray([np.cos(yaw / 2), np.sin(yaw / 2), 0.0, 0.0], np.float32)


def wrist_camera(position) -> np.ndarray:
    """The wrist camera just above the gripper, looking down and ahead."""
    eye = np.asarray(position, np.float64) + [0.0, 0.0, 0.06]
    return scene.look_at_pose7(eye, eye + [0.12, 0.0, -0.3])


def world_points(depth: torch.Tensor, pose7, size: int) -> torch.Tensor:
    """(H, W, 3) float32 world points of a (H, W) depth image seen from
    ``pose7`` through ``scene.intrinsics(size)``."""
    f = float(scene.intrinsics(size)[0, 0])
    d = depth.double()
    v, u = torch.meshgrid(torch.arange(size, dtype=torch.float64, device=d.device),
                          torch.arange(size, dtype=torch.float64, device=d.device),
                          indexing="ij")
    cam = torch.stack([(u - size / 2) / f * d, (v - size / 2) / f * d, d], -1)
    T = torch.as_tensor(scene.pose7_to_matrix64(pose7), device=d.device)
    return (cam @ T[:3, :3].T + T[:3, 3]).float()


def keyframes(count: int, size: int, nhist: int, seed: int, device) -> list:
    """``count`` keyframes, each a dict of host arrays: "rgbs" (1, 4, size,
    size, 3) uint8, "pcds" (1, 4, size, size, 3) float32 world points,
    "gripper_history" (1, nhist, 1, 8) float32 (position, xyzw quaternion,
    openness; the current pose last)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(count):
        boxes = [TABLE]
        for b in range(BOXES):
            half = rng.uniform(0.02, 0.08, 2)
            centre = rng.uniform([-0.1, -0.4], [0.6, 0.4])
            height = rng.uniform(0.04, 0.2)
            lo = (centre[0] - half[0], centre[1] - half[1], TABLE_Z)
            hi = (centre[0] + half[0], centre[1] + half[1], TABLE_Z + height)
            boxes.append((lo, hi, tuple(rng.uniform(0.1, 0.9, 3)), 2 + b))
        boxes = tuple(boxes) + ROOM
        history = []
        position = rng.uniform([0.0, -0.3, TABLE_Z + 0.1], [0.5, 0.3, TABLE_Z + 0.45])
        for _ in range(nhist):
            yaw = rng.uniform(-np.pi, np.pi)
            history.append(np.concatenate([position, gripper_quat_xyzw(yaw),
                                           [float(rng.integers(0, 2))]]).astype(np.float32))
            position = np.clip(position + rng.normal(0.0, 0.05, 3),
                               [-0.2, -0.45, TABLE_Z + 0.05], [0.7, 0.45, TABLE_Z + 0.6])
        history = history[::-1]  # the last drawn is the oldest
        poses = [scene.look_at_pose7(*FIXED_CAMERAS[name]) if name != "wrist"
                 else wrist_camera(history[-1][:3]) for name in CAMERAS]
        rgb, depth, _ = scene_humanoid.render_frames(poses, [boxes] * len(poses), size, device)
        rgb = rgb + RGB_NOISE * torch.randn(rgb.shape, generator=gen, device=device)
        rgb = (rgb.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
        pcds = torch.stack([world_points(depth[i], poses[i], size) for i in range(len(poses))])
        out.append({"rgbs": rgb.cpu().numpy()[None], "pcds": pcds.cpu().numpy()[None],
                    "gripper_history": np.stack(history)[None, :, None, :]})
    return out


def instructions(count: int, tokens: int, seed: int, device) -> list:
    """``count`` (1, tokens, 512) float32 host arrays of normal draws."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return [torch.randn((1, tokens, 512), generator=gen, device=device).cpu().numpy()
            for _ in range(count)]
