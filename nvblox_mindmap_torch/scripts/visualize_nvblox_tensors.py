"""Visualize a saved voxel map: TSDF slices + surface PLY (upstream:
scripts/visualize_nvblox_tensors.py).

The port's counterpart of ``nvblox_mindmap_tpu/scripts/visualize_nvblox_tensors.py``,
with its flags and ``--device`` (the map loads there; default ``cuda``):

    python -m nvblox_mindmap_torch.scripts.visualize_nvblox_tensors \
        --map demo_00000/nvblox_map_static.nvblx --output_dir out/ [--device cpu]

It writes ``tsdf_slice_<i>.png`` (x-slices, red inside the surface, blue in
free space, gray unobserved) and ``surface.ply`` (the surface vertices,
colored by a PCA of their features).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def tsdf_slices_to_images(tsdf: np.ndarray, weight: np.ndarray,
                          num_slices: int = 8) -> np.ndarray:
    """(X, Y, Z) TSDF -> (num_slices, Y, Z, 3) diverging-color slice images."""
    X = tsdf.shape[0]
    idx = np.linspace(0, X - 1, num_slices).astype(int)
    out = []
    scale = np.abs(tsdf).max() or 1.0
    for i in idx:
        t = tsdf[i] / scale  # [-1, 1]
        observed = weight[i] > 0
        r = np.clip(-t, 0, 1)  # inside surface -> red
        b = np.clip(t, 0, 1)  # free space -> blue
        g = np.zeros_like(t)
        img = np.stack([r, g, b], axis=-1)
        out.append(np.where(observed[..., None], img, 0.15))
    return np.stack(out)


def main(argv=None):
    from nvblox_mindmap_torch.data.item_io import encode_png
    from nvblox_mindmap_torch.mapping.constants import MapperId
    from nvblox_mindmap_torch.mapping.mapper import Mapper, get_vertices_and_features
    from nvblox_mindmap_torch.visualization.visualizer import save_feature_pointcloud_ply

    parser = argparse.ArgumentParser()
    parser.add_argument("--map", required=True, help="saved map (Mapper.save_map)")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--num_slices", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="device of the map (default cuda; cpu to run without a card)")
    args = parser.parse_args(argv)

    mapper = Mapper.from_file(args.map, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    state = mapper.states[MapperId.STATIC]
    slices = tsdf_slices_to_images(
        state.tsdf.cpu().numpy(), state.weight.cpu().numpy(), args.num_slices
    )
    for i, img in enumerate(slices):
        encode_png(os.path.join(args.output_dir, f"tsdf_slice_{i}.png"),
                   (img * 255).astype(np.uint8))

    mapper.update_feature_mesh()
    vertices, features = get_vertices_and_features(mapper)
    if len(vertices):
        save_feature_pointcloud_ply(
            os.path.join(args.output_dir, "surface.ply"), vertices, features
        )
    print(f"Wrote {len(slices)} slices + surface.ply ({len(vertices)} vertices)")


if __name__ == "__main__":
    main()
