"""Generate reconstruction figures (color mesh + PCA feature cubes) headlessly.

The port's counterpart of
``nvblox_mindmap_tpu/scripts/generate_reconstruction_figures.py`` (upstream
paper/reconstructions/generate_reconstruction_figures.py): loads a saved map
(of either package) on ``--device`` (default ``cuda``), extracts the color
mesh on that device, renders it and the PCA-colored surface voxels to PNGs,
trims both to a shared white-background bounding box, and caches the PCA
basis so repeated runs color identically. Open3D's interactive viewpoint
capture is replaced by --elev/--azim orthographic parameters; the splat
renderer is host numpy and the PNGs go through the port's own writer.

Usage:
    python -m nvblox_mindmap_torch.scripts.generate_reconstruction_figures \
        --map_path maps/0020.nvblox_map_static.nvblx --output_dir out/ [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from nvblox_mindmap_torch.data.item_io import encode_png


def _render_scatter_png(path, points, colors, elev, azim, size=900):
    """Orthographic painter's-algorithm splat render on white background."""
    el, az = np.deg2rad(elev), np.deg2rad(azim)
    # Camera basis: look direction from (elev, azim).
    look = -np.array([
        np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
    ])
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.cross(right, look)
    center = points.mean(axis=0)
    rel = points - center
    u = rel @ right
    v = rel @ up
    depth = rel @ look
    span = max(u.max() - u.min(), v.max() - v.min(), 1e-9)
    margin = 0.05 * span
    px = ((u - u.min() + margin) / (span + 2 * margin) * (size - 1)).astype(int)
    py = ((v.max() - v + margin) / (span + 2 * margin) * (size - 1)).astype(int)
    order = np.argsort(depth)  # far first; near overwrites (painter's)
    img = np.full((size, size, 3), 255, dtype=np.uint8)
    rgb = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
    r = max(1, size // 450)  # splat radius
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            yy = np.clip(py[order] + dy, 0, size - 1)
            xx = np.clip(px[order] + dx, 0, size - 1)
            img[yy, xx] = rgb[order]
    encode_png(str(path), img)
    return img


def get_trim_box(image):
    """Bounding box of non-white pixels (upstream :35-43)."""
    fg = ~np.all(image == 255, axis=-1)
    rows = np.where(fg.any(axis=1))[0]
    cols = np.where(fg.any(axis=0))[0]
    return rows[0], rows[-1] + 1, cols[0], cols[-1] + 1


def get_minimal_trim_box(a, b):
    return min(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), max(a[3], b[3])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--map_path", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--pca_params_path", type=str, default=None,
                        help="npz cache of the PCA spec (created if missing)")
    parser.add_argument("--recompute_pca", action="store_true")
    parser.add_argument("--elev", type=float, default=35.0)
    parser.add_argument("--azim", type=float, default=-60.0)
    parser.add_argument("--device", default=None,
                        help="device of the map (default cuda; cpu to run without a card)")
    args = parser.parse_args(argv)

    from nvblox_mindmap_torch.mapping.mapper import Mapper, MapperId
    from nvblox_mindmap_torch.visualization.paper_utils import (
        PCASpecification,
        colors_from_features,
        get_surface_voxels,
    )

    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = pathlib.Path(args.map_path).name.split(".")[0]

    mapper = Mapper.from_file(args.map_path, device=args.device)

    # Color mesh figure (vertex colors from the color layer).
    mapper.update_color_mesh(MapperId.STATIC)
    vertices, _, vcolors = mapper.get_color_mesh(MapperId.STATIC)
    color_path = out_dir / f"{stem}_color_mesh.png"
    color_img = _render_scatter_png(
        color_path, np.asarray(vertices), np.asarray(vcolors),
        args.elev, args.azim,
    )

    # Feature-cube figure (PCA colors; basis cached for reuse).
    spec = None
    pca_path = (pathlib.Path(args.pca_params_path)
                if args.pca_params_path else out_dir / "pca_params.npz")
    if pca_path.exists() and not args.recompute_pca:
        data = np.load(pca_path)
        spec = PCASpecification(
            data["projection_matrix"], data["lower_bound"], data["upper_bound"]
        )
    centers, features = get_surface_voxels(mapper)
    fcolors, spec = colors_from_features(features, spec)
    np.savez(
        pca_path,
        projection_matrix=spec.projection_matrix,
        lower_bound=spec.lower_bound,
        upper_bound=spec.upper_bound,
    )
    feature_path = out_dir / f"{stem}_feature_cubes_mesh.png"
    feature_img = _render_scatter_png(
        feature_path, centers, fcolors, args.elev, args.azim
    )

    # Trim both to the shared non-white bounding box (upstream :58-77).
    box = get_minimal_trim_box(get_trim_box(color_img), get_trim_box(feature_img))
    encode_png(str(color_path), color_img[box[0]:box[1], box[2]:box[3]])
    encode_png(str(feature_path), feature_img[box[0]:box[1], box[2]:box[3]])
    print(f"wrote {color_path} and {feature_path}")


if __name__ == "__main__":
    main()
