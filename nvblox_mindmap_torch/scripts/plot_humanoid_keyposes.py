"""Analyze and plot humanoid keypose detection over recorded demos.

(reference: mindmap/scripts/plot_humanoid_keyposes.py) Port of
``nvblox_mindmap_tpu/scripts/plot_humanoid_keyposes.py``. Loads the 37-d
robot states of each demo, runs the humanoid keypose estimator, prints the
indices and writes ``<demo>_keyposes.png``: three panels (both eef heights,
both hands' closedness, the head yaw) over the frames, one vertical line per
keypose. The figure is drawn with numpy into an RGB canvas and written by
the port's PNG writer (no matplotlib): the series in matplotlib's first two
default colours (left blue, right orange), the keyposes in light red, no
text::

    python -m nvblox_mindmap_torch.scripts.plot_humanoid_keyposes \\
        --demo_path dataset/ --output_dir plots/
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Sequence

import numpy as np

from nvblox_mindmap_torch.data.item_io import encode_png
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment

# The figure: matplotlib's (10, 8) inches at 100 dpi, three panels.
FIGURE_HW = (800, 1000)
MARGIN = (40, 60)  # rows, columns around each panel's plot area
SERIES_COLORS = ((31, 119, 180), (255, 127, 14))  # matplotlib's C0, C1
KEYPOSE_COLOR = (255, 179, 179)  # red at alpha 0.3 over white
AXES_COLOR = (128, 128, 128)


def load_robot_states(demo_path: str) -> np.ndarray:
    from nvblox_mindmap_torch.data.dataset import DemoDataset

    return DemoDataset.load_robot_states(demo_path)


def _draw_polyline(canvas: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    """A line through the pixel points (xs, ys), one pixel wide."""
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        cols = np.rint(np.linspace(x0, x1, n)).astype(int)
        rows = np.rint(np.linspace(y0, y1, n)).astype(int)
        canvas[rows, cols] = color
    if len(xs) == 1:
        canvas[int(round(ys[0])), int(round(xs[0]))] = color


def plot_panels(series: Sequence[Sequence[np.ndarray]], keyposes: Sequence[int],
                n_frames: int, hw=FIGURE_HW) -> np.ndarray:
    """(H, W, 3) uint8 figure: one panel per entry of ``series`` (each a list
    of (T,) curves), stacked, sharing the frame axis; every keypose a
    vertical line in each panel."""
    height, width = hw
    canvas = np.full((height, width, 3), 255, np.uint8)
    panel_h = height // len(series)
    top_margin, side_margin = MARGIN
    x0, x1 = side_margin, width - side_margin // 2
    span = max(n_frames - 1, 1)
    for p, curves in enumerate(series):
        y0, y1 = p * panel_h + top_margin // 2, (p + 1) * panel_h - top_margin // 2
        for k in keyposes:
            col = int(round(x0 + (x1 - x0) * k / span))
            canvas[y0:y1 + 1, col] = KEYPOSE_COLOR
        values = np.concatenate([np.asarray(c, np.float64) for c in curves])
        lo, hi = float(values.min()), float(values.max())
        if hi - lo < 1e-9:
            lo, hi = lo - 0.5, hi + 0.5
        xs = x0 + (x1 - x0) * np.arange(n_frames) / span
        for curve, color in zip(curves, SERIES_COLORS):
            ys = y1 - (y1 - y0) * (np.asarray(curve, np.float64) - lo) / (hi - lo)
            _draw_polyline(canvas, xs, ys, color)
        canvas[y0, x0:x1 + 1] = canvas[y1, x0:x1 + 1] = AXES_COLOR
        canvas[y0:y1 + 1, x0] = canvas[y0:y1 + 1, x1] = AXES_COLOR
    return canvas


def analyze_demo(demo_path: str, output_dir: str = None,
                 mode: KeyposeDetectionMode =
                 KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN,
                 plot: bool = True) -> np.ndarray:
    embodiment = HumanoidEmbodiment()
    robot_states = load_robot_states(demo_path)
    keyposes = embodiment.extract_keypose_indices(
        robot_states, extra_keyposes_around_grasp_events=[],
        keypose_detection_mode=mode,
    )
    print(f"{demo_path}: {len(keyposes)} keyposes at {list(keyposes)}")

    if plot and output_dir:
        policy_states = embodiment.policy_states_from_robot_states(robot_states)
        figure = plot_panels(
            [[robot_states[:, 2], robot_states[:, 20]],  # left / right eef z
             [policy_states[:, 7], policy_states[:, 15]],  # left / right closed
             [robot_states[:, 36]]],  # head yaw
            keyposes, len(robot_states))
        os.makedirs(output_dir, exist_ok=True)
        out = os.path.join(output_dir, f"{os.path.basename(demo_path)}_keyposes.png")
        encode_png(out, figure)
        print(f"wrote {out}")
    return keyposes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--demo_path", required=True,
                        help="one demo dir or a dataset root of demo_*")
    parser.add_argument("--output_dir", default=None,
                        help="write plots here (omit for indices only)")
    parser.add_argument(
        "--keypose_detection_mode",
        type=KeyposeDetectionMode,
        default=KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN,
    )
    args = parser.parse_args(argv)

    if "demo" in os.path.basename(os.path.normpath(args.demo_path)):
        demo_paths = [args.demo_path]
    else:
        demo_paths = sorted(glob.glob(os.path.join(args.demo_path, "demo_*")))
        if not demo_paths:
            raise ValueError(f"no demos found in {args.demo_path}")
    return {demo_path: analyze_demo(demo_path, args.output_dir,
                                    mode=args.keypose_detection_mode)
            for demo_path in demo_paths}


if __name__ == "__main__":
    main()
