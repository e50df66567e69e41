"""Closed-loop episode runner: the port's own copy of
``nvblox_mindmap_tpu/closed_loop/runner.py`` (upstream
``mindmap/closed_loop/closed_loop_policy.py``).

Episode loop per demo x retry: reset, warmup frames, then each sim step
updates the policy (map fusion), checks goal-reached / per-goal timeout,
requests a new goal when needed, steps the environment toward the goal and
evaluates success. Failure handling follows upstream: a per-goal step budget
(``max_num_steps_to_goal``), a per-episode step cap, and per-demo retries.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.environment import EnvironmentBase
from nvblox_mindmap_torch.closed_loop.evaluators import EvaluatorBase
from nvblox_mindmap_torch.closed_loop.goals import add_intermediate_goals, is_goal_reached
from nvblox_mindmap_torch.closed_loop.policies import PolicyBase
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase

logger = logging.getLogger("nvblox_mindmap_torch.closed_loop")

MAX_NUM_STEPS_PER_EPISODE = 500
NUM_WARMUP_STEPS = 2  # first sim frames can be invalid (reference: 123-134)


@dataclasses.dataclass
class ClosedLoopConfig:
    max_num_steps: int = MAX_NUM_STEPS_PER_EPISODE
    max_num_steps_to_goal: int = 40
    num_retries: int = 1
    max_intermediate_distance_m: Optional[float] = None
    terminate_after_n_steps: Optional[int] = None


def run_one_episode(
    env: EnvironmentBase,
    policy: PolicyBase,
    embodiment: EmbodimentBase,
    evaluator: EvaluatorBase,
    config: ClosedLoopConfig,
) -> bool:
    """Run one episode; returns success."""
    env.reset()
    for _ in range(NUM_WARMUP_STEPS):
        env.step(None)

    # Queue entries are (goal, is_intermediate): intermediates get the
    # reference's relaxed reached-check (goals.py is_goal_reached).
    goal_queue: List = []
    current_goal: Optional[np.ndarray] = None
    current_is_intermediate = False
    steps_to_goal = 0
    max_steps = config.max_num_steps
    if config.terminate_after_n_steps is not None:
        max_steps = min(max_steps, config.terminate_after_n_steps)

    for step in range(max_steps):
        policy.step(env)
        state = np.asarray(env.get_policy_state())

        need_new_goal = current_goal is None
        if current_goal is not None:
            if is_goal_reached(
                embodiment, state, current_goal,
                is_intermediate_goal=current_is_intermediate,
                max_intermediate_distance_m=config.max_intermediate_distance_m,
            ):
                current_goal = None
                steps_to_goal = 0
                need_new_goal = not goal_queue
            elif steps_to_goal >= config.max_num_steps_to_goal:
                logger.info(
                    "Goal timeout after %d steps at step %d", steps_to_goal, step
                )
                current_goal = None
                steps_to_goal = 0
                need_new_goal = not goal_queue

        if need_new_goal and not goal_queue:
            new_goals = policy.get_new_goal(env)
            if not new_goals:
                # Policy exhausted (e.g. GT policy out of keyposes).
                evaluator.evaluate_step(env)
                break
            new_goals, intermediate_flags = add_intermediate_goals(
                embodiment, state, new_goals, config.max_intermediate_distance_m
            )
            goal_queue.extend(zip(new_goals, intermediate_flags))

        if current_goal is None and goal_queue:
            current_goal, current_is_intermediate = goal_queue.pop(0)
            steps_to_goal = 0

        env.step(current_goal)
        steps_to_goal += 1
        evaluator.evaluate_step(env)
        # Early exit on the sim success term OR the task evaluator's own
        # judgment (task evaluators can succeed on envs whose is_success()
        # never fires, e.g. object-state-only environments).
        if env.is_success() or evaluator.current_success:
            break
    return env.is_success() or evaluator.current_success


def run_closed_loop_policy(
    make_env: Callable[[str], EnvironmentBase],
    make_policy: Callable[[str], PolicyBase],
    embodiment: EmbodimentBase,
    evaluator: EvaluatorBase,
    demo_names: List[str],
    config: ClosedLoopConfig,
    eval_file_path: Optional[str] = None,
):
    """Run all demos with retries; returns the evaluator summary dict."""
    for demo_name in demo_names:
        for attempt in range(config.num_retries):
            env = make_env(demo_name)
            policy = make_policy(demo_name)
            evaluator.start_demo(demo_name, env, retry_idx=attempt)
            run_one_episode(env, policy, embodiment, evaluator, config)
            # The evaluator's finalized verdict decides logging and the
            # retry break - it is the task-semantics judgment, which can
            # disagree with the raw env success term in either direction.
            success = evaluator.finalize_demo(demo_name, env)
            logger.info(
                "Demo %s attempt %d: %s",
                demo_name,
                attempt,
                "SUCCESS" if success else "FAILURE",
            )
            if success:
                break
    summary = evaluator.summarize_demos()
    logger.info("Closed-loop summary: %s", summary)
    if eval_file_path:
        evaluator.write_eval_file(eval_file_path)
    return summary
