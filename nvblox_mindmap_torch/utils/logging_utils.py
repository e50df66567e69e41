"""Metric logging: the console, and wandb when it is asked for.

The port's own copy of ``nvblox_mindmap_tpu/utils/logging_utils.py``
(upstream logs through wandb throughout ``run_training.py``):
per-component train losses, the eval metrics, timings and a trajectory
figure per evaluation. ``wandb`` is imported only when ``wandb_mode`` is not
``"disabled"`` (the default), and then its absence raises; ``matplotlib``
only when a figure is drawn.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np

from nvblox_mindmap_torch.utils.timers import get_mean_time

logger = logging.getLogger("nvblox_mindmap_torch.metrics")


class MetricLogger:
    def __init__(
        self,
        use_wandb: bool = False,
        wandb_project: Optional[str] = None,
        wandb_name: Optional[str] = None,
        wandb_entity: Optional[str] = None,
        wandb_mode: str = "disabled",
        config: Optional[Dict] = None,
        artifact_dir: Optional[str] = None,
    ):
        self.artifact_dir = artifact_dir
        self._wandb = None
        if use_wandb and wandb_mode != "disabled":
            try:
                import wandb
            except ImportError as e:
                raise ImportError(
                    f"--wandb_mode {wandb_mode!r} logs to wandb, which is not "
                    "installed; pass --wandb_mode disabled to log to the console") from e
            wandb.init(project=wandb_project, name=wandb_name, entity=wandb_entity,
                       mode=wandb_mode, config=config)
            self._wandb = wandb

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = ""):
        flat = {}
        for key, value in metrics.items():
            arr = np.asarray(value)
            if arr.ndim == 0:
                flat[f"{prefix}{key}"] = float(arr)
            else:
                for i, v in enumerate(arr.ravel()):
                    flat[f"{prefix}{key}_{i}"] = float(v)
        if self._wandb is not None:
            self._wandb.log(flat, step=step)
        else:
            parts = ", ".join(f"{k}={v:.5f}" for k, v in flat.items())
            logger.info("step %d: %s", step, parts)

    def log_timings(self, step: int, timer_names_to_log):
        """Each named timer's mean (seconds) as ``timings/<name>``."""
        self.log({f"timings/{name}": get_mean_time(name) for name in timer_names_to_log},
                 step)

    def log_trajectory_figure(self, pred_pos, gt_pos, step: int, split: str = "val"
                              ) -> Optional[str]:
        """GT (blue) vs predicted (red) keyposes of the first batch sample
        (upstream run_training.py:65-98, :370-372), as a PNG under
        ``artifact_dir/figures`` and, with a live run, a wandb image. Returns
        the PNG's path (None without ``artifact_dir``). Needs matplotlib."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        pred = np.asarray(pred_pos, dtype=np.float32)[0].reshape(-1, 3)
        gt = np.asarray(gt_pos, dtype=np.float32)[0].reshape(-1, 3)
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(pred[:, 0], pred[:, 1], pred[:, 2], c="red", s=25, alpha=0.8, label="pred")
        ax.scatter(gt[:, 0], gt[:, 1], gt[:, 2], c="blue", s=25, alpha=0.8, label="gt")
        ax.set_xlabel("X Axis")
        ax.set_ylabel("Y Axis")
        ax.set_zlabel("Z Axis")
        ax.set_title("GT(blue) vs pred(red) trajectory")
        ax.legend()
        path = None
        try:
            if self.artifact_dir:
                fig_dir = os.path.join(self.artifact_dir, "figures")
                os.makedirs(fig_dir, exist_ok=True)
                path = os.path.join(fig_dir, f"{split}_trajectory_{step:08d}.png")
                fig.savefig(path, dpi=100, bbox_inches="tight")
            if self._wandb is not None:
                self._wandb.log({f"{split}-viz/viz": self._wandb.Image(fig)}, step=step)
        finally:
            plt.close(fig)
        return path

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
