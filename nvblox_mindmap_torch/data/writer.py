"""Demo writer: per-frame dataset items in the recorded layout.

The port's own counterpart of ``nvblox_mindmap_tpu/data/writer.py``
(upstream ``mindmap/isaaclab_utils/isaaclab_writer.py``), built on
``data/item_io.py`` instead of imageio and zstandard. It writes what
``data/dataset.py`` (and the JAX package's reader) read::

    <demo_dir>/<idx>.<cam>_rgb.png          uint8 HWC
    <demo_dir>/<idx>.<cam>_depth.png        uint16 millimeters
    <demo_dir>/<idx>.<cam>_pose.npy         (7,) pos + wxyz quat, float32
    <demo_dir>/<idx>.<cam>_intrinsics.npy   (3, 3) float32
    <demo_dir>/<idx>.<cam>_semantic.png     uint8 (or uint16) label ids
    <demo_dir>/semantic_labels.json         {label id: class name}
    <demo_dir>/<idx>.robot_state.npy        float32 robot state
    <demo_dir>/<idx>.nvblox_vertex_features.zst
        zstd pickle of {"vertices": f16 (N, 3), "features": f16 (N, C),
        "channel_length": C}
    <demo_dir>/demo_successful.npy          1 SUCCESS / 0 FAILED_DATAGEN /
                                            -1 FAILED_GT_EVAL
"""
from __future__ import annotations

import json
import os

import numpy as np

from nvblox_mindmap_torch.data.item_io import encode_png, pickle_zst
from nvblox_mindmap_torch.data.item_names import NVBLOX_VERTEX_FEATURES_ITEM_NAME
from nvblox_mindmap_torch.mapping.constants import DEPTH_SCALE_FACTOR


class DemoWriter:
    def __init__(self, demo_dir: str, png_compress_level: int = 6):
        self.demo_dir = demo_dir
        self.png_compress_level = png_compress_level
        os.makedirs(demo_dir, exist_ok=True)

    def _path(self, idx: int, item: str) -> str:
        return os.path.join(self.demo_dir, f"{idx}.{item}")

    def write_rgb(self, idx: int, camera: str, rgb: np.ndarray):
        """rgb: (H, W, 3) uint8 or float in [0, 1]."""
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
        encode_png(self._path(idx, f"{camera}_rgb.png"), rgb, self.png_compress_level)

    def write_depth(self, idx: int, camera: str, depth_m: np.ndarray):
        """depth_m: (H, W) metric depth -> uint16 millimeters."""
        depth_u16 = np.clip(depth_m * DEPTH_SCALE_FACTOR, 0, 65535).astype(np.uint16)
        encode_png(self._path(idx, f"{camera}_depth.png"), depth_u16, self.png_compress_level)

    def write_camera_params(self, idx: int, camera: str, pose7: np.ndarray,
                            intrinsics: np.ndarray):
        np.save(self._path(idx, f"{camera}_pose.npy"), np.asarray(pose7, np.float32))
        np.save(self._path(idx, f"{camera}_intrinsics.npy"), np.asarray(intrinsics, np.float32))

    def write_semantic(self, idx: int, camera: str, segmentation: np.ndarray):
        """segmentation: (H, W) integer label ids -> a uint8 PNG, or uint16
        where an id exceeds 255."""
        seg = np.asarray(segmentation)
        if seg.ndim != 2:
            raise ValueError(f"segmentation must be a (H, W) label image, got {seg.shape}")
        dtype = np.uint8 if seg.max(initial=0) < 256 else np.uint16
        encode_png(self._path(idx, f"{camera}_semantic.png"), seg.astype(dtype),
                   self.png_compress_level)

    def write_semantic_labels(self, id_to_class):
        """The label-id -> class-name map that the dynamic mask needs."""
        with open(os.path.join(self.demo_dir, "semantic_labels.json"), "w") as f:
            json.dump({str(int(k)): str(v) for k, v in id_to_class.items()}, f)

    def write_camera_frame(self, idx: int, camera: str, rgb, depth_m, pose7, intrinsics):
        """All four per-camera items of one frame."""
        self.write_rgb(idx, camera, rgb)
        self.write_depth(idx, camera, depth_m)
        self.write_camera_params(idx, camera, pose7, intrinsics)

    def write_robot_state(self, idx: int, robot_state: np.ndarray):
        np.save(self._path(idx, "robot_state.npy"), np.asarray(robot_state, np.float32))

    def write_vertex_features(self, idx: int, vertices: np.ndarray, features: np.ndarray):
        """The mesh's (N, 3) vertices and (N, C) features, stored as fp16."""
        vertices = np.asarray(vertices, np.float16)
        features = np.asarray(features, np.float16)
        if vertices.shape != (len(features), 3):
            raise ValueError(f"vertices {vertices.shape} and features {features.shape} "
                             "must be (N, 3) and (N, C)")
        pickle_zst({"vertices": vertices, "features": features,
                    "channel_length": int(features.shape[1])},
                   self._path(idx, NVBLOX_VERTEX_FEATURES_ITEM_NAME))

    def write_outcome(self, outcome_value: int):
        """1 SUCCESS / 0 FAILED_DATAGEN / -1 FAILED_GT_EVAL."""
        np.save(os.path.join(self.demo_dir, "demo_successful.npy"), np.asarray(outcome_value))
