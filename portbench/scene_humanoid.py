"""The humanoid cell's scene, copied from the port's box world so that later
changes to the program cannot move it: a GR1 head camera over a drill-in-box
table top, and two hands reaching toward the box.

- ``HEAD``, ``LOOK_DISTANCE``, ``LOOK_Z`` and ``head_camera``: the port's
  default head rig (``closed_loop/scene.py``'s ``_pov_pose_from_head_yaw``
  at its default table): the pov camera sits above the table's near edge
  and looks at the table-top point ``LOOK_DISTANCE`` away in the yaw's
  direction; yaw 0 looks along +y, positive yaw turns left;
- ``head_sweep``: the scripted yaw, 0 -> +0.6 -> -0.6 -> 0 rad at 0.05 rad a
  frame over 48 frames, stretched to any frame count;
- ``hand_boxes`` and ``scripted_reach``: both hands, boxes labelled
  ``robot``, reaching from their rest toward the box and back, and the
  17-d policy state at each frame (left pose + closedness, right pose +
  closedness, head yaw);
- ``render_frames``: the benchmark's ray caster over a list of boxes per
  frame, on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import scene

# (min corner, max corner, RGB, label id). Inside drill_in_box's workspace
# [-0.37, -0.75, -0.13] .. [0.95, 0.75, 0.65]: the table, the box the drill
# goes into, the drill, and two objects at the table's ends that only the
# sweep's far yaws see.
STATIC_BOXES = (
    ((-0.30, -0.70, -0.05), (0.90, 0.70, 0.00), (0.55, 0.45, 0.35), 1),
    ((0.45, 0.05, 0.00), (0.75, 0.32, 0.16), (0.30, 0.45, 0.70), 2),
    ((0.12, -0.24, 0.00), (0.22, -0.14, 0.22), (0.85, 0.55, 0.10), 3),
    ((-0.22, 0.10, 0.00), (-0.02, 0.36, 0.12), (0.25, 0.65, 0.30), 4),
    ((0.78, -0.34, 0.00), (0.88, -0.12, 0.10), (0.75, 0.20, 0.25), 5),
)
LABELS = {0: "background", 1: "table", 2: "box", 3: "drill", 4: "bin", 5: "block",
          9: "robot"}
ROBOT = 9
HAND_COLOR = (0.75, 0.75, 0.78)
HAND_HALF = np.asarray([0.035, 0.045, 0.04])
# Hand centres at rest and at full reach (left, right): above the table, in
# front of the box, clear of every static box by more than 7 cm.
HAND_REST = np.asarray([[0.32, -0.48, 0.26], [0.68, -0.48, 0.26]])
HAND_REACH = np.asarray([[0.42, -0.10, 0.28], [0.66, -0.12, 0.28]])
# Palms down, as the app's dummy humanoid goals hold them (wxyz).
HAND_QUATS = np.asarray([[0.5039, 0.4955, -0.5064, 0.4941], [0.4773, 0.5318, -0.4857, 0.5034]])

# The port's default head rig over its default table (centre (0.5, 0,
# -0.025), top at z = 0): the head 0.75 m behind and 0.65 m above the
# table's centre, the gaze 3 cm above the top.
HEAD = np.asarray([0.5, -0.75, 0.625])
LOOK_DISTANCE = 0.7
LOOK_Z = 0.03
SWEEP_FRAMES = 48
SWEEP_YAW = 0.6


def head_camera(yaw: float) -> np.ndarray:
    """(7,) pose of the pov camera at head yaw ``yaw`` (radians)."""
    target = [HEAD[0] - np.sin(yaw) * LOOK_DISTANCE, HEAD[1] + np.cos(yaw) * LOOK_DISTANCE,
              LOOK_Z]
    return scene.look_at_pose7(HEAD, target)


def head_sweep(n: int) -> np.ndarray:
    """(n,) head yaws: 0 -> +0.6 -> -0.6 -> 0 rad on a 48-frame schedule
    (0.05 rad a frame) stretched to ``n`` frames; cycling returns to 0."""
    k = np.arange(n) * SWEEP_FRAMES / n
    quarter = SWEEP_FRAMES / 4
    return np.interp(k, [0, quarter, 3 * quarter, SWEEP_FRAMES],
                     [0.0, SWEEP_YAW, -SWEEP_YAW, 0.0])


def reach(n: int) -> np.ndarray:
    """(n,) share of the way from rest to full reach: out and back once."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def scripted_reach(n: int) -> np.ndarray:
    """(n, 17) policy states: each hand's centre, palm-down quaternion and
    closedness (shut past 80% of the reach), then the head yaw."""
    r = reach(n)[:, None, None]
    centres = HAND_REST[None] + r * (HAND_REACH - HAND_REST)[None]  # (n, 2, 3)
    closed = (r[:, :, 0] > 0.8).astype(np.float64)  # (n, 1)
    hands = [np.concatenate([centres[:, h], np.tile(HAND_QUATS[h], (n, 1)), closed], 1)
             for h in (0, 1)]
    return np.concatenate(hands + [head_sweep(n)[:, None]], 1).astype(np.float32)


def hand_boxes(state) -> list:
    """The two hands of a policy state as boxes labelled ``robot``."""
    return [(tuple(c - HAND_HALF), tuple(c + HAND_HALF), HAND_COLOR, ROBOT)
            for c in (np.asarray(state[0:3], np.float64), np.asarray(state[8:11], np.float64))]


def render_frames(poses7, boxes_per_frame, size: int, device):
    """Ray cast each frame's boxes from its pose (``scene.render_frames``'
    caster, with the boxes given): (rgb (N, H, W, 3) float32, depth (N, H,
    W) float32, segmentation (N, H, W) int32) on ``device``. A ray that hits
    nothing has depth 0."""
    f = scene.FOCAL_512 * size / 512
    v, u = torch.meshgrid(torch.arange(size, dtype=torch.float64, device=device),
                          torch.arange(size, dtype=torch.float64, device=device), indexing="ij")
    rays_cam = torch.stack([(u - size / 2) / f, (v - size / 2) / f, torch.ones_like(u)], -1)
    face_shade = torch.tensor([0.8, 0.65, 1.0], dtype=torch.float64, device=device)
    rgbs, depths, segs = [], [], []
    for pose7, boxes in zip(poses7, boxes_per_frame):
        T = torch.as_tensor(scene.pose7_to_matrix64(pose7), device=device)
        rays = rays_cam @ T[:3, :3].T  # camera z = 1 along each ray: t is the depth
        origin = T[:3, 3]
        depth = torch.full((size, size), float("inf"), dtype=torch.float64, device=device)
        rgb = torch.zeros((size, size, 3), dtype=torch.float64, device=device)
        seg = torch.zeros((size, size), dtype=torch.int32, device=device)
        for lo, hi, color, label in boxes:
            lo = torch.tensor(lo, dtype=torch.float64, device=device)
            hi = torch.tensor(hi, dtype=torch.float64, device=device)
            t1 = (lo - origin) / rays
            t2 = (hi - origin) / rays
            enter = torch.nan_to_num(torch.minimum(t1, t2), nan=-float("inf"))
            leave = torch.nan_to_num(torch.maximum(t1, t2), nan=float("inf"))
            near, far = enter.max(dim=-1).values, leave.min(dim=-1).values
            hit = (near <= far) & (near > 0) & (near < depth)
            depth = torch.where(hit, near, depth)
            shade = face_shade[enter.argmax(dim=-1)][..., None]
            color = torch.tensor(color, dtype=torch.float64, device=device)
            rgb = torch.where(hit[..., None], color * shade, rgb)
            seg = torch.where(hit, torch.full_like(seg, label), seg)
        depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
        rgbs.append(rgb.float())
        depths.append(depth.float())
        segs.append(seg)
    return torch.stack(rgbs), torch.stack(depths), torch.stack(segs)
