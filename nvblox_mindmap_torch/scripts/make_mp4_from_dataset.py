"""Render demo camera streams to video frames (upstream:
scripts/make_mp4_from_dataset.py, video_from_depth.py).

The port's counterpart of ``nvblox_mindmap_tpu/scripts/make_mp4_from_dataset.py``,
with its flags. PNGs are read through the port's own reader; the port has
no video encoder, so each stream is written as numbered PNG frames
``<demo>_<camera>_<modality>_<i:05d>.png`` (``visualization.VideoWriter``):

    python -m nvblox_mindmap_torch.scripts.make_mp4_from_dataset \
        --dataset ds/ --demos 0 --camera wrist --modality rgb --output_dir out/
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from nvblox_mindmap_torch.data.dataset import get_demo_paths
from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.visualization.visualizer import VideoWriter


def depth_to_colormap(depth_m: np.ndarray, max_depth: float = 3.0) -> np.ndarray:
    """Metric depth -> simple turbo-ish RGB visualization in [0, 1]."""
    norm = np.clip(depth_m / max_depth, 0, 1)
    r = np.clip(1.5 - np.abs(2.5 * norm - 1.8), 0, 1)
    g = np.clip(1.5 - np.abs(2.5 * norm - 1.25), 0, 1)
    b = np.clip(1.5 - np.abs(2.5 * norm - 0.6), 0, 1)
    rgb = np.stack([r, g, b], axis=-1)
    return np.where(depth_m[..., None] > 0, rgb, 0.0)


def render_demo_video(demo_path: str, camera: str, output_path: str,
                      modality: str = "rgb", fps: int = 30):
    suffix = f"{camera}_rgb.png" if modality == "rgb" else f"{camera}_depth.png"
    frames = sorted(
        glob.glob(os.path.join(demo_path, f"*.{suffix}")),
        key=lambda p: int(os.path.basename(p).split(".")[0]),
    )
    writer = VideoWriter(output_path, fps=fps)
    for path in frames:
        img = decode_png(path)
        if modality == "rgb":
            writer.add_frame(np.asarray(img, np.uint8))
        else:
            writer.add_frame(depth_to_colormap(np.asarray(img) / 1000.0))
    writer.close()
    return len(frames)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--demos", default="0")
    parser.add_argument("--camera", default="wrist")
    parser.add_argument("--modality", choices=["rgb", "depth"], default="rgb")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--fps", type=int, default=30)
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    for demo_path in get_demo_paths(args.dataset, args.demos):
        name = os.path.basename(demo_path)
        out = os.path.join(
            args.output_dir, f"{name}_{args.camera}_{args.modality}.mp4"
        )
        n = render_demo_video(demo_path, args.camera, out, args.modality, args.fps)
        print(f"{out}: {n} frames")


if __name__ == "__main__":
    main()
