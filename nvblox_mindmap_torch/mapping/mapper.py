"""Mapper: the nvblox_torch-style API over the voxel grid.

Port of ``nvblox_mindmap_tpu/mapping/mapper.py``
(upstream ``mindmap/mapping/isaaclab_nvblox_mapper.py`` and its helpers):

- ``Mapper``: a STATIC (and optionally DYNAMIC) map on one device, with the
  nvblox_torch method surface ``add_depth_frame`` / ``add_color_frame`` /
  ``add_feature_frame`` / ``decay`` / ``clear`` / ``update_feature_mesh`` /
  ``get_feature_mesh``, the color triangle mesh ``update_color_mesh`` /
  ``get_color_mesh`` (Surface Nets on the device or the host) and the
  dense layer views ``tsdf_dense`` / ``features_dense`` / ``colors_dense``
  / ``weight_dense``;
- ``integrate_frame``: the per-frame recipe (depth, then color, then
  features) with mask erosion, border masking and the feature image's
  upscaled intrinsics;
- ``nvblox_integrate``: routes a camera frame into the STATIC map (robot
  pixels masked out) and, with ``include_dynamic``, the DYNAMIC map;
- ``get_vertices_and_features``: the valid surface vertices and features as
  host arrays;
- persistence: ``Mapper.save_map`` / ``load_from_file`` / ``from_file``
  (the pickled {config, state arrays} payload of the JAX package's
  ``save_map``) and ``save_feature_mesh_to_disk`` (the datagen item).

Inputs may be numpy arrays or tensors; they move to the mapper's device.

A map file is read through a restricted unpickler: it admits numpy arrays,
builtin values and the ``MappingConfig`` class of either package (the JAX
package's becomes the port's, which has the same fields), and nothing else,
so a map file cannot run code. The port writes the same payload with its own
``MappingConfig``; the state arrays round-trip bit for bit.
"""
from __future__ import annotations

import io
import logging
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nvblox_mindmap_torch.data.item_io import ArrayUnpickler, pickle_zst
from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.mapping import voxel_grid as vg
from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
from nvblox_mindmap_torch.ops.masks import downscale_mask, erode_mask, get_border_mask
from nvblox_mindmap_torch.utils.timers import span

logger = logging.getLogger("nvblox_mindmap_torch.mapping")


def _tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` on ``device`` as ``dtype``. float64 passes through float32 first,
    as JAX (32-bit mode) canonicalizes it: float64 -> float16 directly can
    round differently from float64 -> float32 -> float16."""
    t = torch.as_tensor(x, device=device)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t if dtype is None else t.to(dtype)


# The MappingConfig classes a map file may name, both read as the port's.
_CONFIG_CLASSES = {("nvblox_mindmap_tpu.mapping.constants", "MappingConfig"),
                   ("nvblox_mindmap_torch.mapping.constants", "MappingConfig")}


class _MapUnpickler(ArrayUnpickler):
    """numpy arrays, builtin values and ``MappingConfig``."""

    def find_class(self, module: str, name: str):
        if (module, name) in _CONFIG_CLASSES:
            return MappingConfig
        return super().find_class(module, name)


def read_map_file(path: str) -> dict:
    """A ``save_map`` payload: {"config": MappingConfig, "state": {field:
    array}}, from a file that either package wrote."""
    with open(path, "rb") as f:
        payload = _MapUnpickler(io.BytesIO(f.read())).load()
    if not isinstance(payload.get("config"), MappingConfig):
        raise ValueError(f"{path}: no MappingConfig in the map file")
    return payload


class Mapper:
    """TSDF + deep-feature voxel mapper, one state per mapper id, on
    ``device`` (default ``cuda``; raises when CUDA is absent and no device
    is given)."""

    def __init__(self, configs: Dict[int, MappingConfig], device: DeviceLike = None):
        self.device = resolve_device(device)
        self.configs = dict(configs)
        self.states = {mid: vg.create_state(cfg, self.device) for mid, cfg in self.configs.items()}
        self._mesh_cache: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        self._color_mesh_cache: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self.last_crossing_count: Optional[int] = None
        # Counters by mapper id, taken at each extraction: the feature pages
        # in use (``update_feature_mesh``) and the vertices that crossed to
        # the host (``get_vertices_and_features``).
        self.live_pages: Dict[int, int] = {}
        self.surface_vertices: Dict[int, int] = {}

    @classmethod
    def dual(cls, config: MappingConfig, device: DeviceLike = None) -> "Mapper":
        """STATIC and DYNAMIC maps of one config; their tensors are separate."""
        return cls({MapperId.STATIC: config, MapperId.DYNAMIC: config}, device)

    @classmethod
    def from_file(cls, path: str, mapper_id: int = MapperId.STATIC,
                  device: DeviceLike = None) -> "Mapper":
        """A single-map mapper from a ``save_map`` file (upstream: nvblox
        ``Mapper(...).load_from_file``); reads the payload once."""
        payload = read_map_file(path)
        mapper = cls({mapper_id: payload["config"]}, device)
        mapper._apply_payload(payload, mapper_id)
        return mapper

    # --- nvblox_torch method surface -----------------------------------------
    def add_depth_frame(self, depth, camera_pose, intrinsics, mask=None,
                        mapper_id: int = MapperId.STATIC):
        d = self.device
        with span("mapper/depth"):
            self.states[mapper_id] = vg.integrate_depth(
                self.states[mapper_id], self.configs[mapper_id],
                _tensor(depth, d, torch.float32), _tensor(camera_pose, d, torch.float32),
                _tensor(intrinsics, d, torch.float32),
                None if mask is None else _tensor(mask, d, torch.bool),
            )

    def add_color_frame(self, rgb, camera_pose, intrinsics, mask_frame=None,
                        mapper_id: int = MapperId.STATIC):
        d = self.device
        with span("mapper/color"):
            rgb = _tensor(rgb, d)
            if rgb.dtype == torch.uint8:
                rgb = rgb.to(torch.float32) / 255.0
            self.states[mapper_id] = vg.integrate_color(
                self.states[mapper_id], self.configs[mapper_id], rgb,
                _tensor(camera_pose, d, torch.float32), _tensor(intrinsics, d, torch.float32),
                None if mask_frame is None else _tensor(mask_frame, d, torch.bool),
            )

    def add_feature_frame(self, features, camera_pose, feature_intrinsics,
                          feature_mask=None, mapper_id: int = MapperId.STATIC):
        d = self.device
        with span("mapper/features"):
            self.states[mapper_id] = vg.integrate_features(
                self.states[mapper_id], self.configs[mapper_id], _tensor(features, d),
                _tensor(camera_pose, d, torch.float32),
                _tensor(feature_intrinsics, d, torch.float32),
                None if feature_mask is None else _tensor(feature_mask, d, torch.bool),
            )

    def decay(self, mapper_id: Optional[int] = None):
        ids = list(self.states) if mapper_id is None else [mapper_id]
        with span("mapper/decay"):
            for mid in ids:
                self.states[mid] = vg.decay(self.states[mid], self.configs[mid])

    def clear(self, mapper_id: Optional[int] = None):
        ids = list(self.states) if mapper_id is None else [mapper_id]
        for mid in ids:
            self.states[mid] = vg.create_state(self.configs[mid], self.device)
        self._mesh_cache.clear()

    # --- mesh / vertex extraction --------------------------------------------
    def update_feature_mesh(self, mapper_id: int = MapperId.STATIC,
                            max_vertices: int = 65536):
        """Extract up to ``max_vertices`` surface vertices; the total crossing
        count lands in ``last_crossing_count`` (a warning when it overflows
        the budget) and the feature pages in use in ``live_pages``, both in
        one copy to the host."""
        with span("mapper/mesh"):
            state = self.states[mapper_id]
            vertices, features, valid, count = vg.extract_surface_vertices(
                state, self.configs[mapper_id], max_vertices, return_count=True)
            self._mesh_cache[mapper_id] = (vertices, features, valid)
            count, pages = torch.stack((count, state.num_pages.to(count.dtype))).tolist()
            self.last_crossing_count = count
            self.live_pages[mapper_id] = pages
        if self.last_crossing_count > max_vertices:
            logger.warning(
                "surface extraction overflow: %d zero-crossings > max_vertices=%d; the "
                "mesh is truncated (raise max_vertices or the voxel size)",
                self.last_crossing_count, max_vertices,
            )

    def get_feature_mesh(self, mapper_id: int = MapperId.STATIC):
        """(vertices (N, 3), features (N, F), valid (N,)) on the device;
        extracts on demand if ``update_feature_mesh`` was not called."""
        if mapper_id not in self._mesh_cache:
            self.update_feature_mesh(mapper_id)
        return self._mesh_cache[mapper_id]

    def update_color_mesh(self, mapper_id: int = MapperId.STATIC,
                          backend: str = "device",
                          max_vertices: int = 65536,
                          max_triangles: int = 262144):
        """Extract a triangle mesh with per-vertex colors (upstream: nvblox
        ``update_color_mesh`` / ``get_color_mesh``, for visualization).

        ``backend="device"`` runs Surface Nets on the map's device
        (``vg.extract_surface_mesh_device``, fixed budgets, a warning when
        they overflow); ``"host"`` runs ``surface_nets`` in numpy (no
        budget). Either way the mesh and its colors land on the host; the
        feature pool stays on the device.

        As in the JAX package, the result is one cache for the mapper, not
        one per ``mapper_id``, and ``clear`` keeps it.
        """
        cfg = self.configs[mapper_id]
        state = self.states[mapper_id]
        if backend == "device":
            (vertices, vertex_valid, cells, triangles, tri_valid,
             n_vertices, n_triangles) = vg.extract_surface_mesh_device(
                state, cfg, max_vertices, max_triangles)
            n_vertices, n_triangles = int(n_vertices), int(n_triangles)
            if n_vertices > max_vertices or n_triangles > max_triangles:
                logger.warning(
                    "color-mesh budget overflow: %d vertices / %d triangles (budget %d / %d); "
                    "mesh truncated", n_vertices, n_triangles, max_vertices, max_triangles)
            vertices = vertices[vertex_valid].cpu().numpy()
            cells = cells[vertex_valid].cpu().numpy()
            triangles = triangles[tri_valid].cpu().numpy()
        elif backend == "host":
            from nvblox_mindmap_torch.mapping.surface_nets import surface_nets

            vertices, triangles, cells = surface_nets(
                state.tsdf.cpu().numpy(), state.weight.cpu().numpy(), cfg.voxel_size_m,
                np.asarray(cfg.aabb_min_m, dtype=np.float64),
                truncation=cfg.truncation_distance_m)
        else:
            raise ValueError(f"backend must be 'device' or 'host', got {backend!r}")
        colors = self._lookup_pool_host(
            state.page_table.cpu().numpy(), cfg, cells, state.color.cpu().numpy(),
            state.color_weight.cpu().numpy())
        self._color_mesh_cache = (vertices, triangles, colors)

    def get_color_mesh(self, mapper_id: int = MapperId.STATIC):
        """(vertices (V, 3), triangles (T, 3), colors (V, 3)) host arrays;
        extracts on the device if ``update_color_mesh`` was not called."""
        if self._color_mesh_cache is None:
            self.update_color_mesh(mapper_id)
        return self._color_mesh_cache

    @staticmethod
    def _lookup_pool_host(page_table: np.ndarray, cfg: MappingConfig, voxels: np.ndarray,
                          pool, pool_weight) -> np.ndarray:
        """Per-voxel pool lookup on the host: (N, C) float32, zero where the
        voxel has no page or no weight; every argument a host array."""
        if len(voxels) == 0:
            return np.zeros((0, np.asarray(pool).shape[-1]), np.float32)
        b = cfg.block_size
        page_table = np.asarray(page_table)
        pool = np.asarray(pool)
        pool_weight = np.asarray(pool_weight)
        vx, vy, vz = voxels.T
        page = page_table[vx // b, vy // b, vz // b]
        slot = ((vx % b) * b + (vy % b)) * b + (vz % b)
        safe = np.maximum(page, 0)
        values = pool[safe, slot].astype(np.float32)
        has = (page >= 0) & (pool_weight[safe, slot] > 0)
        return np.where(has[:, None], values, 0.0)

    # --- dense queries (layer views), on the map's device --------------------
    def tsdf_dense(self, mapper_id: int = MapperId.STATIC) -> torch.Tensor:
        """(X, Y, Z) TSDF, unobserved voxels at the config's ``unobserved_value``."""
        return vg.query_tsdf_dense(self.states[mapper_id], self.configs[mapper_id])

    def features_dense(self, mapper_id: int = MapperId.STATIC) -> torch.Tensor:
        """(X, Y, Z, F) fp32 feature grid (zeros where unallocated)."""
        return vg.query_features_dense(self.states[mapper_id], self.configs[mapper_id])

    def colors_dense(self, mapper_id: int = MapperId.STATIC) -> torch.Tensor:
        """(X, Y, Z, 3) fp32 color grid (zeros where unallocated)."""
        return vg.query_colors_dense(self.states[mapper_id], self.configs[mapper_id])

    def weight_dense(self, mapper_id: int = MapperId.STATIC) -> torch.Tensor:
        return self.states[mapper_id].weight

    # --- persistence ---------------------------------------------------------
    def save_map(self, path: str, mapper_id: int = MapperId.STATIC):
        """Pickle {config, state arrays} of one map, as the JAX package does."""
        payload = {"config": self.configs[mapper_id],
                   "state": vg.state_to_numpy(self.states[mapper_id])}
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    def load_from_file(self, path: str, mapper_id: int = MapperId.STATIC):
        self._apply_payload(read_map_file(path), mapper_id)

    def _apply_payload(self, payload, mapper_id: int):
        self.configs[mapper_id] = payload["config"]
        self.states[mapper_id] = vg.state_from_numpy(payload["state"], self.device)
        self._mesh_cache.pop(mapper_id, None)


def integrate_frame(
    mapper: Mapper,
    config: MappingConfig,
    depth_frame,
    feature_frame,
    intrinsics,
    camera_pose,
    rgb,
    input_mask,
    input_mask_erosion_iterations: int,
    valid_depth_mask_erosion_iterations: int,
    mapper_id: int,
) -> Dict[str, torch.Tensor]:
    """Per-frame fusion recipe: depth, then color, then features, with mask
    hygiene (upstream ``helpers/nvblox_mapping_helpers.py:integrate_frame``).

    Returns the depth mask and the feature mask, on the mapper's device.
    """
    d = mapper.device
    depth_frame = _tensor(depth_frame, d, torch.float32)
    input_mask = _tensor(input_mask, d, torch.bool)
    valid_depth_mask = depth_frame > config.min_integration_distance_m
    depth_mask = input_mask & valid_depth_mask

    mapper.add_depth_frame(depth_frame, camera_pose, intrinsics, depth_mask, mapper_id)
    mapper.add_color_frame(rgb, camera_pose, intrinsics, depth_mask, mapper_id)

    # Eroded masks for the (convolution-bled) feature image.
    input_eroded = erode_mask(input_mask, iterations=input_mask_erosion_iterations)
    depth_eroded = erode_mask(valid_depth_mask, iterations=valid_depth_mask_erosion_iterations)
    mask_eroded = input_eroded & depth_eroded

    fh, fw = feature_frame.shape[:2]
    if fh != fw:
        raise ValueError(f"square feature images only, got {fh}x{fw}")
    upscale = fh / depth_frame.shape[0]
    feature_intrinsics = np.asarray(
        intrinsics.cpu() if isinstance(intrinsics, torch.Tensor) else intrinsics,
        dtype=np.float32).copy()
    feature_intrinsics[:2, :] *= upscale

    # Nearest upscale of the mask to the feature resolution.
    reps = int(round(upscale))
    if reps >= 1:
        mask_up = mask_eroded.repeat_interleave(reps, 0).repeat_interleave(reps, 1)
    else:
        mask_up = downscale_mask(mask_eroded[None, None], int(round(1 / upscale)))[0, 0]
    border = get_border_mask((fh, fw), config.feature_mask_border_percent, device=d)
    feature_mask = border & mask_up

    mapper.add_feature_frame(_tensor(feature_frame, d, torch.float16), camera_pose,
                             feature_intrinsics, feature_mask, mapper_id)
    return {"depth_mask": depth_mask, "feature_mask": feature_mask}


def nvblox_integrate(
    mapper: Mapper,
    config: MappingConfig,
    depth_frame,
    feature_frame,
    intrinsics,
    camera_pose,
    rgb,
    dynamic_mask,
    include_dynamic: bool,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Route one camera frame into the STATIC (and optionally DYNAMIC) map.

    Robot pixels (``dynamic_mask``, from the task's ``dynamic_class_labels``)
    stay out of the static map and, with ``include_dynamic``, go into the
    DYNAMIC one with its own erosion radius. Without a segmentation channel
    (``dynamic_mask is None``) everything is static.
    """
    if config.use_dynamic_mask and dynamic_mask is not None:
        static_mask = ~_tensor(dynamic_mask, mapper.device, torch.bool)
    else:
        static_mask = torch.ones(tuple(depth_frame.shape), dtype=torch.bool, device=mapper.device)

    images = {
        "STATIC": integrate_frame(
            mapper, config, depth_frame, feature_frame, intrinsics, camera_pose, rgb,
            input_mask=static_mask,
            input_mask_erosion_iterations=config.static_mask_erosion_iterations,
            valid_depth_mask_erosion_iterations=config.valid_depth_mask_erosion_iterations,
            mapper_id=MapperId.STATIC,
        )
    }
    if include_dynamic:
        if dynamic_mask is None:
            raise ValueError(
                "include_dynamic requires a segmentation channel "
                "(CameraFrame.segmentation) to build the dynamic mask from")
        images["DYNAMIC"] = integrate_frame(
            mapper, config, depth_frame, feature_frame, intrinsics, camera_pose, rgb,
            input_mask=_tensor(dynamic_mask, mapper.device, torch.bool),
            input_mask_erosion_iterations=config.dynamic_mask_erosion_iterations,
            valid_depth_mask_erosion_iterations=config.valid_depth_mask_erosion_iterations,
            mapper_id=MapperId.DYNAMIC,
        )
    return images


def get_vertices_and_features(
    mapper: Mapper,
    mapper_id: int = MapperId.STATIC,
    remove_zero_features: bool = False,
    num_excess_features: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Valid surface vertices (N, 3) and features (N, F) as host arrays.

    ``num_excess_features`` trailing (padding) channels are dropped first;
    ``remove_zero_features`` discards vertices whose features are all zero,
    so featureless points never reach the vertex sample budget. The
    filtering runs on the device; only the kept rows cross to the host.
    Their count lands in ``mapper.surface_vertices[mapper_id]``.
    """
    with span("mapper/mesh_to_host"):
        vertices, features, valid = mapper.get_feature_mesh(mapper_id)
        vertices, features = vertices[valid], features[valid]
        if num_excess_features > 0:
            features = features[..., :-num_excess_features]
        if remove_zero_features:
            nonzero = ~(features == 0).all(dim=1)
            vertices, features = vertices[nonzero], features[nonzero]
        vertices = vertices.cpu().numpy()
        mapper.surface_vertices[mapper_id] = len(vertices)
        return vertices, features.cpu().numpy()


def save_feature_mesh_to_disk(
    mapper: Mapper,
    path: str,
    mapper_id: int = MapperId.STATIC,
    remove_zero_features: bool = True,
    num_excess_features: int = 0,
    include_dynamic: bool = False,
):
    """Write the feature mesh as the datagen item: a zstd pickle of
    {"vertices" f16 (N, 3), "features" f16 (N, F), "channel_length" F}.

    ``remove_zero_features`` defaults True, as upstream's datagen export
    does (``nvblox_to_disk_helpers.py:41-45``). ``include_dynamic`` appends
    the DYNAMIC map's vertices after the static ones (upstream asserts this
    unsupported; the JAX package and the port support it).
    """
    mapper.update_feature_mesh(mapper_id)
    vertices, features = get_vertices_and_features(
        mapper, mapper_id, remove_zero_features, num_excess_features)
    if include_dynamic:
        mapper.update_feature_mesh(MapperId.DYNAMIC)
        dyn_v, dyn_f = get_vertices_and_features(
            mapper, MapperId.DYNAMIC, remove_zero_features, num_excess_features)
        vertices = np.concatenate([vertices, dyn_v], axis=0)
        features = np.concatenate([features, dyn_f], axis=0)
    pickle_zst({"vertices": vertices.astype(np.float16),
                "features": features.astype(np.float16),
                "channel_length": int(features.shape[1])}, path)
