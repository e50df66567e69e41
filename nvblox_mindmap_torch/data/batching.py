"""Batch collation and model-input assembly (host-side numpy).

The port's own copy of ``nvblox_mindmap_tpu/data/batching.py`` (upstream
``mindmap/data_loading/batching.py``). ``collate_batch`` stacks
per-sample item dicts; ``unpack_batch`` turns a collated batch into the
channel-last model-input dict consumed by
``models.diffuser_actor.prepare_inputs``: point clouds are backprojected from
depth on the fly, policy states are split per embodiment, mesh vertices come
with validity masks.

Backprojection runs in numpy here (host); the device path in
``ops/backprojection.py`` is used by the closed-loop policy where inputs are
already on-device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from nvblox_mindmap_torch.data.data_types import (
    DataType,
    includes_mesh,
    includes_pcd,
    includes_policy_states,
    includes_rgb,
)
from nvblox_mindmap_torch.data.item_names import (
    GT_POLICY_STATE_PRED_ITEM_NAME,
    IS_KEYPOSE_ITEM_NAME,
    NVBLOX_VERTEX_FEATURES_ITEM_NAME,
    POLICY_STATE_HISTORY_ITEM_NAME,
)
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase
from nvblox_mindmap_torch.geometry.np_rotations import quat_to_matrix


def collate_batch(samples: List[Dict]) -> Dict:
    """Stack a list of per-sample dicts into a batch dict."""
    assert samples
    out: Dict = {}
    for key in samples[0].keys():
        values = [s[key] for s in samples]
        if isinstance(values[0], dict):
            stacked = {
                "features": np.stack([v["features"] for v in values]),
                "vertices": np.stack([v["vertices"] for v in values]),
                "vertices_valid_mask": np.stack(
                    [v["vertices_valid_mask"] for v in values]
                ),
                "channel_length": values[0]["channel_length"],
            }
            for v in values[1:]:
                assert v["channel_length"] == stacked["channel_length"]
            out[key] = stacked
        else:
            out[key] = np.stack([np.asarray(v) for v in values])
    return out


def _structure_depth_items(depth_camera_item_names: Sequence[str]) -> List[Dict]:
    depth_items = [n for n in depth_camera_item_names if "depth" in n]
    pose_items = [n for n in depth_camera_item_names if "pose" in n]
    intr_items = [n for n in depth_camera_item_names if "intrinsics" in n]
    assert len(pose_items) == len(depth_items) == len(intr_items)
    structured = []
    for depth_name in depth_items:
        prefix = depth_name.split("_")[0]
        structured.append(
            {
                "depth": depth_name,
                "pose": next(n for n in pose_items if n.startswith(prefix)),
                "intrinsics": next(n for n in intr_items if n.startswith(prefix)),
            }
        )
    return structured


_UV1_CACHE: Dict = {}


def _uv1_grid(H: int, W: int) -> np.ndarray:
    """Cached (H*W, 3) homogeneous pixel grid (shared across batches)."""
    key = (H, W)
    grid = _UV1_CACHE.get(key)
    if grid is None:
        jj, ii = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        grid = (
            np.stack([ii, jj, np.ones_like(ii)], axis=-1)
            .reshape(-1, 3)
            .astype(np.float32)
        )
        _UV1_CACHE[key] = grid
    return grid


def _backproject_np(
    depth: np.ndarray, intrinsics: np.ndarray, position: np.ndarray,
    quat_wxyz: np.ndarray,
) -> np.ndarray:
    """(B, H, W) depth -> (B, H, W, 3) world points (numpy).

    The loader's hot path, in float32 with one 2D sgemm per item (numpy's
    float64 batched kernels are far slower than float32 BLAS, and fp32 is
    exact enough for metric depth: sub-0.1 mm at camera ranges). The 3x3
    algebra (inverse, quaternion) stays float64; the composed per-camera
    matrix is then cast down.
    """
    B, H, W = depth.shape
    uv1 = _uv1_grid(H, W)
    k_inv = np.linalg.inv(intrinsics.astype(np.float64))
    rot = quat_to_matrix(quat_wxyz.astype(np.float64))
    # world = rot @ (k_inv @ uv1) * depth + t  ==  (uv1 @ (rot @ k_inv)^T) * d + t
    M = np.swapaxes(rot @ k_inv, -1, -2).astype(np.float32)
    out = np.empty((B, H * W, 3), np.float32)
    for b in range(B):
        rays = uv1 @ M[b]  # (H*W, 3) sgemm
        np.multiply(rays, depth[b].reshape(-1, 1), out=out[b])
        out[b] += position[b].astype(np.float32)
    # Upstream zeroes non-finite points (backprojection.py:136). Points can
    # only be non-finite when an input is, so gate the expensive multi-pass
    # nan_to_num on a single cheap depth sweep (the common all-finite case).
    if not (
        np.isfinite(depth).all()
        and np.isfinite(M).all()
        and np.isfinite(position).all()
    ):
        np.nan_to_num(out, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
    return out.reshape(B, H, W, 3)


def unpack_batch(
    embodiment: EmbodimentBase,
    batch: Dict,
    data_type: DataType,
    add_external_cam: bool,
    rgbd_min_depth_threshold: float = 0.0,
) -> Dict:
    """Collated batch -> model-input dict (channel-last numpy arrays)."""
    samples: Dict = {
        "rgbs": None,
        "pcds": None,
        "pcd_valid_mask": None,
        "vertex_features": None,
        "vertices": None,
        "vertices_valid_mask": None,
        "gripper_history": None,
        "gt_gripper_pred": None,
        "gt_head_yaw": None,
        "is_keypose": None,
        "instruction": None,
    }
    items = embodiment.get_camera_item_names_by_encoding_method(add_external_cam)

    if includes_policy_states(data_type):
        hist = batch[POLICY_STATE_HISTORY_ITEM_NAME]
        samples["gripper_history"] = embodiment.split_gripper_tensor(hist)
        gt = batch[GT_POLICY_STATE_PRED_ITEM_NAME]
        samples["gt_gripper_pred"] = embodiment.split_gripper_tensor(gt)
        samples["gt_head_yaw"] = embodiment.split_head_yaw_tensor(gt)
        samples["is_keypose"] = batch[IS_KEYPOSE_ITEM_NAME]

    if includes_rgb(data_type):
        samples["rgbs"] = np.stack(
            [batch[name] for name in items["rgb"]], axis=1
        )  # (B, ncam, H, W, 3)

    if includes_pcd(data_type):
        cams = _structure_depth_items(items["depth"])
        pcds, valid = [], []
        for cam in cams:
            depth = batch[cam["depth"]]
            pose = batch[cam["pose"]]
            pcds.append(
                _backproject_np(
                    depth, batch[cam["intrinsics"]], pose[:, :3], pose[:, 3:]
                )
            )
            valid.append(depth > rgbd_min_depth_threshold)
        samples["pcds"] = np.stack(pcds, axis=1)
        samples["pcd_valid_mask"] = np.stack(valid, axis=1)

    if includes_mesh(data_type):
        mesh = batch[NVBLOX_VERTEX_FEATURES_ITEM_NAME]
        # Keep features fp16 (their on-disk dtype): halves the host->device
        # feed volume; the model's embedding matmul upcasts on device.
        samples["vertex_features"] = mesh["features"].astype(np.float16)
        samples["vertices"] = mesh["vertices"].astype(np.float32)
        samples["vertices_valid_mask"] = mesh["vertices_valid_mask"]

    return samples
