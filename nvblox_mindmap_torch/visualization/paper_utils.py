"""Paper-figure utilities: surface feature cubes, PCA color specs, USD export.

The port's own copy of ``nvblox_mindmap_tpu/visualization/paper_utils.py``
(upstream ``mindmap/paper/utils/utils.py`` and
``paper/teaser/convert_maps_usd.py``), headless, on the port's ``Mapper``:

- ``PCASpecification`` / ``get_pca_specification`` / ``colors_from_features``:
  the quantile-bounded PCA color mapping (utils.py:25-30, 146-188);
- ``get_surface_voxels`` / ``get_feature_cubes_mesh``: the surface voxels
  (tsdf < 0, observed, with integrated features) as a PCA-colored cube mesh
  (utils.py:100-137), read from the block-paged state after one copy of it
  to the host, without the dense 768-d grid;
- ``usda_from_mesh`` / ``save_mesh_usda``: a triangle mesh with per-vertex
  display colors and normals as an ASCII ``.usda`` stage (utils.py:32-69),
  written by hand, no ``pxr``;
- ``convert_maps_to_usd``: one USD per saved map (convert_maps_usd.py:25-60).

Open3D windows are out of scope (headless tooling); PLY / PNG / USD files
cover inspection.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional, Tuple

import numpy as np

from nvblox_mindmap_torch.device import DeviceLike
from nvblox_mindmap_torch.mapping import voxel_grid as vg
from nvblox_mindmap_torch.mapping.mapper import Mapper, MapperId
from nvblox_mindmap_torch.visualization.visualizer import get_voxel_mesh


@dataclasses.dataclass
class PCASpecification:
    """Reusable 3D PCA projection with robust display bounds."""

    projection_matrix: np.ndarray  # (C, 3)
    lower_bound: np.ndarray  # (3,) 1% quantile of projected values
    upper_bound: np.ndarray  # (3,) 99% quantile


def get_pca_specification(features: np.ndarray) -> PCASpecification:
    """Fit the PCA color basis on (N, C) features.

    Zero (never-integrated) features are excluded from the *basis* fit; the
    1%/99% display bounds are then taken over ALL rows' projections - both
    exactly as the reference does (paper/utils/utils.py:146-166: pca_lowrank
    on the nonzero rows, quantile over `features @ projection`). Callers that
    want zero rows out of the bounds too should filter before calling (the
    surface-voxel extractors here already drop zero-feature voxels).
    """
    features = np.asarray(features, dtype=np.float64)
    assert features.ndim == 2
    valid = ~np.all(features == 0, axis=-1)
    nonzero = features[valid]
    if nonzero.shape[0] == 0:
        raise ValueError("cannot fit a PCA basis: all features are zero")
    mean = nonzero.mean(axis=0)
    _, _, vt = np.linalg.svd(nonzero - mean, full_matrices=False)
    projection = vt[:3].T  # (C, 3)
    projected = features @ projection
    return PCASpecification(
        projection_matrix=projection.astype(np.float32),
        lower_bound=np.quantile(projected, 0.01, axis=0).astype(np.float32),
        upper_bound=np.quantile(projected, 0.99, axis=0).astype(np.float32),
    )


def colors_from_features(
    features: np.ndarray, pca_specification: Optional[PCASpecification] = None
) -> Tuple[np.ndarray, PCASpecification]:
    """(N, C) features -> ((N, 3) RGB in [0, 1], spec) (utils.py:169-188)."""
    features = np.asarray(features, dtype=np.float64)
    assert features.ndim == 2
    if pca_specification is None:
        pca_specification = get_pca_specification(features)
    rgb = features @ pca_specification.projection_matrix.astype(np.float64)
    span = pca_specification.upper_bound - pca_specification.lower_bound
    span = np.where(np.abs(span) > 1e-12, span, 1.0)
    rgb = (rgb - pca_specification.lower_bound) / span
    return np.clip(rgb, 0.0, 1.0).astype(np.float32), pca_specification


def get_surface_voxels(
    mapper: Mapper,
    mapper_id: int = MapperId.STATIC,
    tsdf_threshold: float = 0.0,
    weight_threshold: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Surface voxel (centers (N, 3), features (N, F)) from a fused map.

    Surface = tsdf < tsdf_threshold, tsdf weight > weight_threshold and a
    positive integrated feature weight (reference utils.py:100-126: per-block
    valid_tsdf & valid_feature_weights masks).
    """
    cfg = mapper.configs[mapper_id]
    state = vg.state_to_numpy(mapper.states[mapper_id])  # one copy to the host
    tsdf = state["tsdf"]
    weight = state["weight"]
    surface = (tsdf < tsdf_threshold) & (weight > weight_threshold)
    vx, vy, vz = np.nonzero(surface)
    voxels = np.stack([vx, vy, vz], axis=-1)
    if voxels.shape[0] == 0:
        fd = state["feat"].shape[-1]
        return np.zeros((0, 3), np.float32), np.zeros((0, fd), np.float32)
    features = mapper._lookup_pool_host(
        state["page_table"], cfg, voxels, state["feat"], state["feat_weight"]
    )
    has_features = ~np.all(features == 0, axis=-1)
    voxels = voxels[has_features]
    features = features[has_features]
    centers = (
        np.asarray(cfg.aabb_min_m, dtype=np.float64)
        + (voxels.astype(np.float64) + 0.5) * cfg.voxel_size_m
    ).astype(np.float32)
    return centers, features


def get_feature_cubes_mesh(
    mapper: Mapper,
    mapper_id: int = MapperId.STATIC,
    pca_specification: Optional[PCASpecification] = None,
):
    """PCA-colored voxel-cube mesh of the feature surface.

    Returns ((V, 3) vertices, (T, 3) triangles, (V, 3) colors, spec) -
    the reference's get_open3d_feature_cubes_mesh (utils.py:100-137) with the
    o3d mesh replaced by plain arrays.
    """
    centers, features = get_surface_voxels(mapper, mapper_id)
    if centers.shape[0] == 0:
        raise ValueError("map has no surface voxels with features")
    colors, pca_specification = colors_from_features(features, pca_specification)
    cfg = mapper.configs[mapper_id]
    vertices, triangles, vertex_colors = get_voxel_mesh(
        centers, cfg.voxel_size_m, colors=colors
    )
    return vertices, triangles, vertex_colors, pca_specification


def compute_vertex_normals(
    vertices: np.ndarray, triangles: np.ndarray
) -> np.ndarray:
    """Area-weighted per-vertex normals (o3d compute_vertex_normals parity)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)
    normals = np.zeros_like(vertices)
    if triangles.shape[0]:
        a = vertices[triangles[:, 0]]
        b = vertices[triangles[:, 1]]
        c = vertices[triangles[:, 2]]
        face_n = np.cross(b - a, c - a)  # magnitude = 2x area (weighting)
        for i in range(3):
            np.add.at(normals, triangles[:, i], face_n)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.where(norm > 1e-20, norm, 1.0)).astype(np.float32)


def _fmt_vec3(arr: np.ndarray) -> str:
    return ", ".join(f"({v[0]:.6g}, {v[1]:.6g}, {v[2]:.6g})" for v in arr)


def usda_from_mesh(
    vertices: np.ndarray,
    triangles: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    prim_path: str = "/World/reconstruction",
) -> str:
    """Serialize a triangle mesh as an ASCII USD (usda) stage.

    Matches the stage layout the reference builds through pxr
    (utils.py:32-69): /World default prim, a Mesh child with points,
    faceVertexIndices/Counts, vertex-interpolated displayColor and normals.
    """
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    parts = pathlib.PurePosixPath(prim_path).parts
    assert len(parts) == 3 and parts[0] == "/", (
        "prim_path must be /<root>/<mesh>"
    )
    root, mesh_name = parts[1], parts[2]
    if normals is None:
        normals = compute_vertex_normals(vertices, triangles)
    lines = [
        "#usda 1.0",
        "(",
        f'    defaultPrim = "{root}"',
        ")",
        "",
        f'def Xform "{root}"',
        "{",
        f'    def Mesh "{mesh_name}"',
        "    {",
        f"        point3f[] points = [{_fmt_vec3(vertices)}]",
        "        int[] faceVertexIndices = ["
        + ", ".join(str(int(i)) for i in triangles.reshape(-1))
        + "]",
        "        int[] faceVertexCounts = ["
        + ", ".join("3" for _ in range(triangles.shape[0]))
        + "]",
        f"        normal3f[] normals = [{_fmt_vec3(normals)}] ("
        + 'interpolation = "vertex")',
    ]
    if colors is not None:
        colors = np.asarray(colors, dtype=np.float32).reshape(-1, 3)
        assert colors.shape[0] == vertices.shape[0]
        lines.append(
            "        color3f[] primvars:displayColor = "
            + f"[{_fmt_vec3(colors)}] ("
            + 'interpolation = "vertex")'
        )
    lines += ["    }", "}", ""]
    return "\n".join(lines)


def save_mesh_usda(
    path: str,
    vertices: np.ndarray,
    triangles: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
) -> None:
    with open(path, "w") as f:
        f.write(usda_from_mesh(vertices, triangles, colors, normals))


def convert_maps_to_usd(
    input_dir: str,
    pattern: str = "*nvblox_map_static*",
    pca_specification: Optional[PCASpecification] = None,
    device: DeviceLike = None,
) -> list:
    """Export every saved map under input_dir as a .usda feature-cube mesh.

    Maps are the Mapper.save_map pickle format (of either package), loaded
    on ``device`` (default ``cuda``; raises when CUDA is absent and no
    device is given); the PCA basis is fit on the first map and reused so
    colors are consistent across the sequence (reference
    convert_maps_usd.py:25-60).
    """
    out_paths = []
    paths = sorted(
        p for p in pathlib.Path(input_dir).glob(pattern)
        if p.suffix not in (".usda", ".usd")
    )
    if not paths:
        raise FileNotFoundError(
            f"no maps matching {pattern!r} under {input_dir}"
        )
    for map_path in paths:
        mapper = Mapper.from_file(str(map_path), device=device)
        vertices, triangles, colors, pca_specification = (
            get_feature_cubes_mesh(
                mapper, MapperId.STATIC, pca_specification
            )
        )
        usd_path = map_path.with_suffix(".usda")
        save_mesh_usda(str(usd_path), vertices, triangles, colors)
        out_paths.append(str(usd_path))
    return out_paths
