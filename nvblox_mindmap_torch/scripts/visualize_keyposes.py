"""Export keypose / trajectory visualizations as PLY (upstream:
scripts/visualize_keyposes.py, plot_humanoid_keyposes.py).

The port's counterpart of ``nvblox_mindmap_tpu/scripts/visualize_keyposes.py``,
with its flags: one ``<demo>_keyposes.ply`` per demo, the end-effector
trajectory gray and its keyposes red (green where the gripper is closed).

    python -m nvblox_mindmap_torch.scripts.visualize_keyposes \
        --dataset ds/ --demos 0 --task cube_stacking --output_dir out/
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from nvblox_mindmap_torch.apps.run_training import resolve_keypose_params
from nvblox_mindmap_torch.data.dataset import DemoDataset, get_demo_paths
from nvblox_mindmap_torch.embodiments.registry import Tasks, make_embodiment_for_task
from nvblox_mindmap_torch.visualization.visualizer import save_pointcloud_ply


def export_keyposes(dataset: str, demos: str, task: Tasks, output_dir: str):
    embodiment = make_embodiment_for_task(task)

    class _A:  # minimal args shim for resolve_keypose_params
        extra_keyposes_around_grasp_events = None
        keypose_detection_mode = None

    _A.task = task
    extra, mode = resolve_keypose_params(_A)
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for demo_path in get_demo_paths(dataset, demos):
        ds = DemoDataset(
            os.path.dirname(demo_path),
            demos=str(int(os.path.basename(demo_path).split("_")[-1])),
            embodiment=embodiment,
            item_names=["runtime_is_keypose"],
            use_keyposes=True,
            extra_keyposes_around_grasp_events=extra,
            keypose_detection_mode=mode,
        )
        info = ds.demo_info[list(ds.demo_info)[0]]
        states = info["policy_states"]
        keyposes = info["keypose_indices"]
        # Color: gray trajectory, red keyposes (green if gripper closed).
        colors = np.tile([0.6, 0.6, 0.6], (len(states), 1))
        closed = states[keyposes][:, 7] > 0.5
        colors[keyposes] = np.where(
            closed[:, None], [0.0, 0.8, 0.0], [0.9, 0.1, 0.1]
        )
        out = os.path.join(
            output_dir, os.path.basename(demo_path) + "_keyposes.ply"
        )
        save_pointcloud_ply(out, states[:, :3], colors)
        written.append(out)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--demos", default="0")
    parser.add_argument("--task", required=True)
    parser.add_argument("--output_dir", required=True)
    args = parser.parse_args(argv)
    print(export_keyposes(args.dataset, args.demos, Tasks(args.task),
                          args.output_dir))


if __name__ == "__main__":
    main()
