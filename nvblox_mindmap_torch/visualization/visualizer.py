"""Headless visualization: PLY point-cloud export and PCA / attention colors.

The port's own copy of the parts of
``nvblox_mindmap_tpu/visualization/visualizer.py`` that the open-loop app
and the experiments reach (upstream ``mindmap/visualization/*``, whose
Open3D windows this replaces with files), host numpy as there:

- ``save_pointcloud_ply``: ASCII PLY with per-point colors (feature-PCA or
  attention-weight colormaps), loadable in any viewer;
- ``get_voxel_mesh``: a cube mesh per voxel centre;
- the pink-green colour map and ``attention_to_colors``;
- ``compute_pca_basis_from_dataset``: one PCA basis over a loader's vertex
  features.

``TensorVisualizer`` and ``VideoWriter`` (PNG grids, wandb and mp4 through
``imageio``) are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from nvblox_mindmap_torch.image.pca import PcaProjection, apply_pca_return_projection, fit_pca


def save_pointcloud_ply(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
):
    """Write an ASCII PLY of (N, 3) points with optional (N, 3) [0,1] colors."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        if colors is not None:
            rgb = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            for p, c in zip(points, rgb):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def get_voxel_mesh(
    centers: np.ndarray,
    voxel_size_m: float,
    colors: Optional[np.ndarray] = None,
):
    """Cube mesh for a set of voxel centers.

    Equivalent of nvblox_torch.visualization.get_voxel_mesh (reference:
    paper/utils/utils.py:16-18): each (N, 3) center becomes an axis-aligned
    cube of edge voxel_size_m. Returns (vertices (8N, 3), triangles (12N, 3),
    vertex_colors (8N, 3) or None) - feed to save_mesh_ply for viewing.
    """
    centers = np.asarray(centers, dtype=np.float32).reshape(-1, 3)
    n = centers.shape[0]
    h = 0.5 * float(voxel_size_m)
    corner = np.array(
        [[sx, sy, sz] for sx in (-h, h) for sy in (-h, h) for sz in (-h, h)],
        dtype=np.float32,
    )  # (8, 3), ordered (---,--+,-+-,-++,+--,+-+,++-,+++)
    vertices = (centers[:, None, :] + corner[None, :, :]).reshape(-1, 3)
    # 12 triangles per cube over the corner ordering above (outward winding).
    face = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        dtype=np.int64,
    )
    triangles = (face[None, :, :] + 8 * np.arange(n)[:, None, None]).reshape(
        -1, 3
    )
    vertex_colors = None
    if colors is not None:
        vertex_colors = np.repeat(
            np.asarray(colors, dtype=np.float32).reshape(-1, 3), 8, axis=0
        )
    return vertices, triangles, vertex_colors


def save_feature_pointcloud_ply(
    path: str,
    points: np.ndarray,
    features: np.ndarray,
    projection: Optional[PcaProjection] = None,
) -> PcaProjection:
    """PLY with feature-PCA colors; returns the projection for reuse."""
    rgb, projection = apply_pca_return_projection(features, projection)
    save_pointcloud_ply(path, points, rgb)
    return projection


def get_pink_green_color_map(n: int = 256) -> np.ndarray:
    """(n, 3) diverging green -> near-white -> pink colormap.

    Functional equivalent of the reference's hardcoded 256-entry LUT
    (visualization/color_maps/color_map_green_pink_tones.py) - generated
    procedurally (gamma-shaped interpolation between the same endpoints)
    rather than copied. Endpoints: dark green (0, 0.24, 0.02), pale
    green-white midpoint, dark pink (0.24, 0.05, 0.24).
    """
    dark_green = np.array([0.0, 0.2424, 0.0232])
    pale = np.array([0.93, 0.945, 0.93])
    dark_pink = np.array([0.2443, 0.0513, 0.2413])
    t = np.linspace(0.0, 1.0, n)[:, None]
    first = t < 0.5
    u = np.where(first, t * 2.0, (t - 0.5) * 2.0)
    # Ease toward the pale midpoint (the reference ramps roughly linearly in
    # each half with a slight perceptual bend).
    lo = dark_green + (pale - dark_green) * u
    hi = pale + (dark_pink - pale) * u
    return np.where(first, lo, hi).astype(np.float32)


def values_to_pink_green(values: np.ndarray) -> np.ndarray:
    """Map scalars (any shape) onto the diverging green-pink colormap."""
    v = np.asarray(values, dtype=np.float64)
    lo, hi = float(v.min()), float(v.max())
    u = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    cmap = get_pink_green_color_map()
    idx = np.clip((u * (len(cmap) - 1)).astype(int), 0, len(cmap) - 1)
    return cmap[idx]


def attention_to_colors(weights: np.ndarray, min_weight: float = 0.0) -> np.ndarray:
    """(N,) attention weights -> (N, 3) heat colors (black -> red -> yellow)."""
    w = np.asarray(weights, dtype=np.float64)
    w = np.where(w < min_weight, 0.0, w)
    if w.max() > 0:
        w = w / w.max()
    r = np.clip(2 * w, 0, 1)
    g = np.clip(2 * w - 1, 0, 1)
    return np.stack([r, g, np.zeros_like(w)], axis=-1).astype(np.float32)


def compute_pca_basis_from_dataset(
    data_loader, max_num_samples_for_pca: int = 200
) -> PcaProjection:
    """Fit one stable PCA basis over a dataset's vertex features.

    (reference: visualization/visualization.py:321-349) Colors stay
    consistent across frames/episodes when every visualization reuses the
    returned projection. ``data_loader`` yields model-ready batch dicts with
    a "vertex_features" entry (any loader from data/loader.py works).
    """
    features = []
    for idx, batch in enumerate(data_loader):
        if idx >= max_num_samples_for_pca:
            break
        feats = np.asarray(batch["vertex_features"], dtype=np.float32)
        features.append(feats.reshape(-1, feats.shape[-1]))
    if not features:
        raise ValueError("data loader yielded no batches with vertex features")
    return fit_pca(np.concatenate(features, axis=0))
