"""Triangle-mesh extraction from the TSDF (host-side Surface Nets).

The port's own copy of ``nvblox_mindmap_tpu/mapping/surface_nets.py``
(upstream exports marching-cubes color / feature meshes for visualization:
nvblox ``update_color_mesh`` / ``get_color_mesh``), host numpy as there. The
policy reads only surface *vertices* and features; triangle connectivity is
a visualization concern. Surface Nets is the dual method:

- one vertex per cell that contains a sign change, at the mean of its edge
  zero-crossings;
- a quad (two triangles) across every grid edge with a sign change, joining
  the four cells around it.

It is the oracle of the device pass (``voxel_grid.extract_surface_mesh_device``)
and the ``backend="host"`` path of ``Mapper.update_color_mesh``; colors per
vertex come from the mapper's pools through the owning cell.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def surface_nets(
    tsdf: np.ndarray,
    weight: np.ndarray,
    voxel_size: float,
    origin: np.ndarray,
    truncation: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract a triangle mesh from a dense TSDF.

    Args:
        tsdf: (X, Y, Z) signed distances.
        weight: (X, Y, Z) observation weights (0 = unobserved).
        voxel_size: meters per voxel.
        origin: (3,) world position of the GRID CORNER (aabb_min); voxel
            (i, j, k)'s center is origin + (idx + 0.5) * voxel_size, as in
            ``voxel_grid.voxel_centers_flat``.
        truncation: corners with |tsdf| >= truncation count as unobserved.

    Returns:
        (vertices (V, 3) float32,
         triangles (T, 3) int32,
         vertex_voxels (V, 3) int32: the owning cell, for attribute lookup)
    """
    X, Y, Z = tsdf.shape
    observed = weight > 0
    if truncation is not None:
        near = np.abs(tsdf) < truncation
    else:
        near = np.ones_like(observed)

    # Cells are the (X-1, Y-1, Z-1) dual lattice; a cell is active when its
    # 8 corners are observed and their signs differ.
    signs = tsdf >= 0

    def corner(a, dx, dy, dz):
        return a[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]

    all_obs = np.ones((X - 1, Y - 1, Z - 1), dtype=bool)
    any_pos = np.zeros_like(all_obs)
    any_neg = np.zeros_like(all_obs)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                all_obs &= corner(observed & near, dx, dy, dz)
                s = corner(signs, dx, dy, dz)
                any_pos |= s
                any_neg |= ~s
    active = all_obs & any_pos & any_neg
    cell_idx = np.argwhere(active)  # (V, 3)
    if len(cell_idx) == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0, 3), np.int32),
        )

    # Vertex position: mean of the cell's edge zero-crossings (float64).
    cx, cy, cz = cell_idx.T
    corners = np.empty((len(cell_idx), 2, 2, 2))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corners[:, dx, dy, dz] = tsdf[cx + dx, cy + dy, cz + dz]

    # The 12 cube edges as (corner_a, corner_b, axis) in (dx, dy, dz) coords.
    edges = []
    for axis in range(3):
        for u in (0, 1):
            for v in (0, 1):
                a = [u, v]
                a.insert(axis, 0)
                b = [u, v]
                b.insert(axis, 1)
                edges.append((tuple(a), tuple(b), axis))

    acc = np.zeros((len(cell_idx), 3))
    counts = np.zeros(len(cell_idx))
    for a, b, axis in edges:
        va = corners[:, a[0], a[1], a[2]]
        vb = corners[:, b[0], b[1], b[2]]
        crossing = (va >= 0) != (vb >= 0)
        denom = va - vb
        safe_denom = np.where(np.abs(denom) > 1e-12, denom, 1.0)
        t = np.where(np.abs(denom) > 1e-12, va / safe_denom, 0.5)
        point = np.stack([cx, cy, cz], axis=1).astype(np.float64)
        point += np.asarray([a], dtype=np.float64)
        point[:, axis] += t
        acc += np.where(crossing[:, None], point, 0.0)
        counts += crossing
    centers = acc / np.maximum(counts, 1)[:, None]
    vertices = (origin + (centers + 0.5) * voxel_size).astype(np.float32)

    # Vertex index per cell.
    vid = -np.ones((X - 1, Y - 1, Z - 1), dtype=np.int64)
    vid[cx, cy, cz] = np.arange(len(cell_idx))

    # Faces: for each axis, grid edges with a sign change join 4 cells.
    triangles = []
    for axis in range(3):
        o1, o2 = [a for a in range(3) if a != axis]
        # Edge from voxel v to v + e_axis; the 4 cells around it are
        # v - d1 * e_o1 - d2 * e_o2 for d1, d2 in {0, 1}.
        sl_a = [slice(0, X), slice(0, Y), slice(0, Z)]
        sl_b = list(sl_a)
        dims = [X, Y, Z]
        sl_a[axis] = slice(0, dims[axis] - 1)
        sl_b[axis] = slice(1, dims[axis])
        ea = signs[tuple(sl_a)]
        eb = signs[tuple(sl_b)]
        eobs = (observed & near)[tuple(sl_a)] & (observed & near)[tuple(sl_b)]
        change = (ea != eb) & eobs
        coords = np.argwhere(change)
        if len(coords) == 0:
            continue
        # Orientation by sign direction; axis 1's (o1, o2) = (0, 2) is a
        # left-handed frame around +y (x-hat cross z-hat = -y-hat), so its
        # winding is inverted to keep all faces consistently oriented.
        flips = ea[tuple(coords.T)] ^ (axis == 1)
        quads = []
        ok = np.ones(len(coords), dtype=bool)
        for d1 in (0, 1):
            for d2 in (0, 1):
                c = coords.copy()
                c[:, o1] -= d1
                c[:, o2] -= d2
                in_range = (
                    (c >= 0).all(axis=1)
                    & (c[:, 0] < X - 1)
                    & (c[:, 1] < Y - 1)
                    & (c[:, 2] < Z - 1)
                )
                ids = np.full(len(coords), -1, dtype=np.int64)
                ids[in_range] = vid[tuple(c[in_range].T)]
                ok &= ids >= 0
                quads.append(ids)
        q00, q01, q10, q11 = quads  # (d1, d2) = (0,0), (0,1), (1,0), (1,1)
        q00, q01, q10, q11 = (q[ok] for q in (q00, q01, q10, q11))
        flips = flips[ok]
        # Two triangles per quad, wound by the sign direction.
        t1 = np.where(
            flips[:, None], np.stack([q00, q10, q11], 1),
            np.stack([q00, q11, q10], 1),
        )
        t2 = np.where(
            flips[:, None], np.stack([q00, q11, q01], 1),
            np.stack([q00, q01, q11], 1),
        )
        triangles.append(t1)
        triangles.append(t2)

    tris = (
        np.concatenate(triangles).astype(np.int32)
        if triangles
        else np.zeros((0, 3), np.int32)
    )
    return vertices, tris, cell_idx.astype(np.int32)


def save_mesh_ply(path: str, vertices: np.ndarray, triangles: np.ndarray,
                  colors: Optional[np.ndarray] = None):
    """ASCII PLY with faces (and optional per-vertex colors in [0, 1])."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(triangles)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            rgb = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            for p, c in zip(vertices, rgb):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in vertices:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for t in triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
