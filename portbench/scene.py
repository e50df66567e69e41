"""The benchmark's traffic and input generators, copied from the repository's
chip smoke script so that later changes to the program cannot move them.

- ``SCENE_BOXES`` and ``render_frames``: a table top with boxes, ray cast
  (float64) from a pinhole camera; the smoke script's numpy caster, here in
  torch so that it runs on the card in set-up.
- ``scripted_pick`` and ``wrist_camera``: a pick-and-place arm trajectory and
  the ego camera that rides above its end effector.
- ``train_batches``: training batches of RGB-D frames whose points lie inside
  the workspace, 2048 mesh vertices with features, a gripper history and a
  ground-truth keypose, made on the device from a generator.
"""
from __future__ import annotations

import numpy as np
import torch

# (min corner, max corner, RGB, label id): a table top (z = 0), three boxes on
# it and one box labelled "robot".
SCENE_BOXES = (
    ((-0.30, -0.70, -0.05), (0.90, 0.70, 0.00), (0.55, 0.45, 0.35), 1),
    ((0.05, -0.40, 0.00), (0.25, -0.18, 0.14), (0.80, 0.20, 0.20), 2),
    ((0.35, 0.05, 0.00), (0.52, 0.28, 0.22), (0.20, 0.70, 0.30), 3),
    ((0.55, -0.20, 0.00), (0.75, 0.02, 0.09), (0.20, 0.30, 0.80), 4),
    ((0.00, 0.30, 0.00), (0.16, 0.46, 0.48), (0.60, 0.60, 0.60), 9),
)
SCENE_LABELS = {0: "background", 1: "table", 2: "box_a", 3: "box_b", 4: "box_c", 9: "robot"}
FOCAL_512 = 400.0  # px at 512x512
# Share of the training frames' 16x16 pixel blocks under a depth hole.
HOLE_SHARE = 0.1


def look_at_pose7(eye, target) -> np.ndarray:
    """(7,) position + wxyz quaternion of a camera at ``eye`` whose +z looks
    at ``target``, +y pointing down."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z], axis=1)
    t = np.trace(R)
    if t > 0:
        s = 2.0 * np.sqrt(t + 1.0)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0)
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return np.concatenate([eye, np.asarray(q) / np.linalg.norm(q)]).astype(np.float32)


def pose7_to_matrix64(pose7) -> np.ndarray:
    """(4, 4) float64 camera-to-world matrix of a position + wxyz quaternion."""
    p = np.asarray(pose7, np.float64)
    w, x, y, z = p[3:] / np.linalg.norm(p[3:])
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = p[:3]
    return T


def intrinsics(size: int) -> np.ndarray:
    f = FOCAL_512 * size / 512
    return np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)


def render_frames(poses7, size: int, device):
    """Ray cast the scene from each pose: (rgb (N, H, W, 3) float32,
    depth (N, H, W) float32, segmentation (N, H, W) int32) on ``device``.
    A ray that hits nothing has depth 0."""
    f = FOCAL_512 * size / 512
    v, u = torch.meshgrid(torch.arange(size, dtype=torch.float64, device=device),
                          torch.arange(size, dtype=torch.float64, device=device), indexing="ij")
    rays_cam = torch.stack([(u - size / 2) / f, (v - size / 2) / f, torch.ones_like(u)], -1)
    face_shade = torch.tensor([0.8, 0.65, 1.0], dtype=torch.float64, device=device)
    rgbs, depths, segs = [], [], []
    for pose7 in poses7:
        T = torch.as_tensor(pose7_to_matrix64(pose7), device=device)
        rays = rays_cam @ T[:3, :3].T  # camera z = 1 along each ray: t is the depth
        origin = T[:3, 3]
        depth = torch.full((size, size), float("inf"), dtype=torch.float64, device=device)
        rgb = torch.zeros((size, size, 3), dtype=torch.float64, device=device)
        seg = torch.zeros((size, size), dtype=torch.int32, device=device)
        for lo, hi, color, label in SCENE_BOXES:
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


def scripted_pick(n: int) -> np.ndarray:
    """(n, 8) arm policy states (position, wxyz quaternion, closedness):
    descend, grasp, carry over an arch, lower, release, lift, on the smoke
    script's 48-frame schedule stretched to ``n`` frames."""
    i = np.linspace(0, 47, n)
    x = np.interp(i, [0, 12, 18, 35, 47], [0.40, 0.45, 0.45, 0.60, 0.60])
    y = np.interp(i, [0, 12, 18, 35, 47], [-0.15, -0.10, -0.10, 0.15, 0.15])
    z = np.interp(i, [0, 12, 18, 35, 41, 47], [0.30, 0.08, 0.08, 0.12, 0.12, 0.30])
    arch = (i > 18) & (i < 35)
    z[arch] += 0.25 * np.sin(np.pi * (i[arch] - 18) / 17)
    closed = ((i >= 14.5) & (i <= 38.5)).astype(np.float64)  # jaw shut 17-36, half-way cut
    quat = np.tile([0.0, 1.0, 0.0, 0.0], (n, 1))  # gripper pointing down
    return np.concatenate([x[:, None], y[:, None], z[:, None], quat, closed[:, None]],
                          1).astype(np.float32)


def wrist_camera(state) -> np.ndarray:
    """The ego camera 0.25 m above the end effector, looking down and ahead."""
    eye = np.asarray(state[:3], np.float64) + [0.0, 0.0, 0.25]
    return look_at_pose7(eye, [eye[0] + 0.15, eye[1], 0.0])


def train_batches(count: int, batch: int, cameras: int, image: int, patch: int,
                  vertices: int, feature_dim: int, nhist: int, workspace,
                  generator: torch.Generator, device):
    """``count`` training batches on ``device``, every row different: RGB in
    [0, 1], world points, vertices and poses inside ``workspace``, depth holes over
    ``HOLE_SHARE`` of the ``patch`` x ``patch`` pixel blocks, mesh vertices
    and normal features, a gripper history and a ground-truth keypose
    (position, unit wxyz quaternion, closedness)."""
    lo, hi = (torch.as_tensor(np.asarray(workspace)[i], dtype=torch.float32, device=device)
              for i in (0, 1))

    def uniform(shape, a=0.0, b=1.0):
        return a + (b - a) * torch.rand(shape, generator=generator, device=device)

    def pose8(shape):
        quat = torch.randn(shape + (4,), generator=generator, device=device)
        quat = quat / quat.norm(dim=-1, keepdim=True)
        close = torch.randint(0, 2, shape + (1,), generator=generator, device=device)
        return torch.cat([lo + (hi - lo) * uniform(shape + (3,)), quat, close.float()], -1)

    out = []
    for _ in range(count):
        shape = (batch, cameras, image, image)
        grid = image // patch
        holes = uniform((batch, cameras, grid, grid)) < HOLE_SHARE
        out.append({
            "gripper_history": pose8((batch, nhist, 1)),
            "gt_gripper_pred": pose8((batch, 1, 1)),
            "vertices": lo + (hi - lo) * uniform((batch, vertices, 3)),
            "vertex_features": torch.randn((batch, vertices, feature_dim), generator=generator,
                                           device=device),
            "vertices_valid_mask": torch.ones((batch, vertices), dtype=torch.bool, device=device),
            "rgbs": uniform(shape + (3,)),
            "pcds": lo + (hi - lo) * uniform(shape + (3,)),
            "pcd_valid_mask": ~holes.repeat_interleave(patch, 2).repeat_interleave(patch, 3),
        })
    return out
