"""Demo validation app: the port's counterpart of
``nvblox_mindmap_tpu/apps/run_validate_demos.py`` (upstream
``mindmap/run_validate_demos.py``).

Replays each demo's ground-truth keyposes closed-loop in the kinematic world
and overwrites ``demo_successful.npy`` with FAILED_GT_EVAL for demos whose
keyposes cannot be executed: the fault-detection pass that keeps bad demos
out of training. The work is host numpy; like every entry point of the port
it runs with ``--device cuda`` unless ``--device cpu`` is given, and raises
without a card.

Usage::

    python -m nvblox_mindmap_torch.apps.run_validate_demos \\
        --task cube_stacking --dataset <path> --demos_closed_loop 0-9
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.environment import KinematicEnvironment
from nvblox_mindmap_torch.closed_loop.evaluators import BasicEvaluator
from nvblox_mindmap_torch.closed_loop.policies import GroundTruthPolicy
from nvblox_mindmap_torch.closed_loop.runner import ClosedLoopConfig, run_one_episode
from nvblox_mindmap_torch.data.dataset import DemoOutcome, get_demo_paths
from nvblox_mindmap_torch.device import resolve_device
from nvblox_mindmap_torch.embodiments.registry import (
    TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS,
    TASK_TO_KEYPOSE_DETECTION_MODE,
    make_embodiment_for_task,
)
from nvblox_mindmap_torch.mapping.constants import Tasks
from nvblox_mindmap_torch.utils.config import ClosedLoopAppArgs, parse_args

logger = logging.getLogger("nvblox_mindmap_torch.run_validate_demos")


def main(argv: Optional[List[str]] = None, task=None, dataset=None,
         demos=None) -> Dict[str, bool]:
    """Validate the demos; returns {demo path: GT keyposes executed}."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    # As upstream, the app parses the closed-loop argument set (its
    # ValidateDemosAppArgs has no task field; run_validate_demos.py:44).
    args = parse_args(ClosedLoopAppArgs, argv)
    resolve_device(None if args.device == "cuda" else args.device)
    task = task or args.task
    dataset = dataset or args.dataset
    demos = demos or args.demos_closed_loop
    if task is None or dataset is None:
        raise ValueError("--task and --dataset are required")
    task = Tasks(task)

    embodiment = make_embodiment_for_task(task)
    extra = TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS[task]
    mode = TASK_TO_KEYPOSE_DETECTION_MODE[task]

    results = {}
    for demo_path in get_demo_paths(dataset, demos):
        gt = GroundTruthPolicy.from_demo(demo_path, embodiment, extra, mode)
        initial = gt.goals[0]
        waypoints = [g[:3] for g in gt.goals[1:]]
        env = KinematicEnvironment(embodiment, initial, waypoints)
        evaluator = BasicEvaluator()
        evaluator.start_demo(demo_path)
        # Serve the goals after the initial one for execution.
        policy = GroundTruthPolicy(np.stack(gt.goals[1:])) if len(gt.goals) > 1 else gt
        success = run_one_episode(
            env, policy, embodiment, evaluator,
            ClosedLoopConfig(
                max_num_steps_to_goal=args.max_num_steps_to_goal,
                max_intermediate_distance_m=args.max_intermediate_distance_m,
                terminate_after_n_steps=args.terminate_after_n_steps,
            ),
        )
        results[demo_path] = success
        if not success:
            np.save(os.path.join(demo_path, "demo_successful.npy"),
                    np.asarray(DemoOutcome.FAILED_GT_EVAL.value))
            logger.info("Demo %s marked FAILED_GT_EVAL", demo_path)
    logger.info("Validated %d demos, %d failed", len(results),
                sum(not v for v in results.values()))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
