"""Colorize a directory of depth images into video frames.

The port's counterpart of ``nvblox_mindmap_tpu/scripts/video_from_depth.py``
(upstream mindmap/scripts/video_from_depth.py, through nvblox_python_tools'
clip / colorize / video helpers), with its arguments: matplotlib's turbo
colormap (its table carried in ``visualization/turbo_colormap.py``) and the
package's ``VideoWriter``, which writes the frames as numbered PNGs
``<output stem>_<i:05d>.png`` (the port has no video encoder). Accepts the
recorded dataset's uint16 PNGs (``*depth.png``, millimeters) or raw float
``*.npy`` depth frames.

    python -m nvblox_mindmap_torch.scripts.video_from_depth \
        dataset/demo_00000 out.mp4 --pattern '*.wrist_depth.png'
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.data.transforms import DEPTH_SCALE_FACTOR
from nvblox_mindmap_torch.visualization.turbo_colormap import turbo
from nvblox_mindmap_torch.visualization.visualizer import VideoWriter


def clip_to_max(depth: np.ndarray, max_value: float) -> np.ndarray:
    return np.minimum(np.nan_to_num(depth, nan=max_value, posinf=max_value),
                      max_value)


def get_colorized_image(depth: np.ndarray) -> np.ndarray:
    """Normalized depth -> uint8 RGB via matplotlib's turbo colormap."""
    lo, hi = float(depth.min()), float(depth.max())
    norm = (depth - lo) / max(hi - lo, 1e-9)
    return (turbo(norm) * 255).astype(np.uint8)


def load_depth(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.squeeze(np.load(path)).astype(np.float32)
    return np.asarray(decode_png(path), np.float32) / DEPTH_SCALE_FACTOR


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("depth_dir")
    parser.add_argument("output_path")
    parser.add_argument("--pattern", default="*depth.png",
                        help="glob within depth_dir (also tries frame*.npy)")
    parser.add_argument("--max_depth_m", type=float, default=3.0)
    parser.add_argument("--frame_rate", type=int, default=20)
    args = parser.parse_args(argv)

    def frame_key(p):
        # Digit-prefixed frames sort numerically, anything else after them
        # lexically: the key must be one comparable type.
        stem = os.path.basename(p).split(".")[0]
        return (0, int(stem), "") if stem.isdigit() else (1, 0, stem)

    paths = sorted(
        glob.glob(os.path.join(args.depth_dir, args.pattern)), key=frame_key
    )
    if not paths:
        paths = sorted(glob.glob(os.path.join(args.depth_dir, "frame*.npy")))
    if not paths:
        raise ValueError(
            f"no depth frames matching {args.pattern!r} in {args.depth_dir}"
        )

    writer = VideoWriter(args.output_path, fps=args.frame_rate)
    for path in paths:
        depth = clip_to_max(load_depth(path), args.max_depth_m)
        writer.add_frame(get_colorized_image(depth))
    writer.close()
    print(f"wrote {len(paths)} frames to {args.output_path}")


if __name__ == "__main__":
    main()
