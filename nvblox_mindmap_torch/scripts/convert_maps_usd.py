"""Convert saved maps to USD (.usda) feature-cube meshes.

The port's counterpart of ``nvblox_mindmap_tpu/scripts/convert_maps_usd.py``
(upstream paper/teaser/convert_maps_usd.py:25-86): loads every saved map in
a directory (of either package) on ``--device`` (default ``cuda``),
extracts the PCA-colored surface voxel-cube mesh, and writes an ASCII USD
stage next to each map. The PCA basis is fit on the first map and reused
for consistent colors.

Usage:
    python -m nvblox_mindmap_torch.scripts.convert_maps_usd \
        --input_dir maps/ [--pattern '*nvblox_map_static*'] [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_dir", type=str, required=True,
                        help="Directory containing Mapper.save_map files")
    parser.add_argument("--pattern", type=str, default="*nvblox_map_static*",
                        help="Glob pattern selecting map files")
    parser.add_argument("--device", default=None,
                        help="device of the maps (default cuda; cpu to run without a card)")
    args = parser.parse_args(argv)

    if not pathlib.Path(args.input_dir).is_dir():
        raise ValueError(f"Input directory {args.input_dir} does not exist")

    from nvblox_mindmap_torch.visualization.paper_utils import convert_maps_to_usd

    for path in convert_maps_to_usd(args.input_dir, args.pattern, device=args.device):
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
