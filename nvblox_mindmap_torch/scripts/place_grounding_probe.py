"""Place-grounding probe: does the predicted RELEASE position track the
support cube across scenes?

The closed-loop failure chain on cube_stacking (docs/pages/benchmarks.md)
was long diagnosed as exposure drift / demonstration coverage; this probe
measures the sharper question underneath it. Protocol, per scene:

1. Drive the scripted expert (closed_loop/scripted.scripted_stack_goals)
   through approach / descend / grasp / lift, mapping every frame - the
   gripper history at the hand-off is exactly an on-distribution expert
   prefix and carries NO information about where the support cube is
   (the history is [start, pick approach, pick, lift]: pick-cube only).
2. Hand control to the policy and record the first goal that commands an
   open gripper while the cube is held - its xy is where the policy
   intends to release.
3. Regress release-xy on the support cube's xy over N freshly randomized
   scenes (disjoint seed base from training and held-out evals).

slope ~ 1, r ~ 1  =>  the place is grounded in the mapped observation.
slope ~ 0          =>  the place is a memorized dataset prior: open-loop
keypose error stays excellent (validation conditions on the EXPERT history,
which - at transport/place keyposes - already heads toward the target, so
the leak hides the failure), while closed-loop success is decided by
whether the scene's support cube happens to sit near the prior.

Measured with the JAX package (8 expert demos, the committed task-success
fixture):
slope_x = -0.14, slope_y = -0.11, r_x = -0.72, median release error
0.191 m, every release inside a ~4 cm cluster at the training scenes' mean
place position. The same probe run after HG-DAgger retraining (8 expert +
32 corrective demos) shows the same clustering - corrective data diversifies
the TARGETS but cannot create perception the gradient never needed with 8
memorizable scenes. See docs/pages/benchmarks.md for the scaling study this
motivated (the reference escapes the same regime with 100-130 teleoperated
demos per task, model_cards/model_overview.md:114).

Reference protocol anchor: the closed-loop hand-off mirrors
closed_loop/closed_loop_policy.py:242-317 (policy drives from a mapped
history); there is no reference counterpart for the probe itself.

This is the port's counterpart of
``nvblox_mindmap_tpu/scripts/place_grounding_probe.py``, with its flags and
``--device`` (default ``cuda``): the model loads through
``task_success_experiment.load_model`` (a port- or JAX-written checkpoint),
the policy is the port's, and its goals run through the flash kernels, as
the experiment's closed-loop stage runs them. The figures above are the JAX
package's runs.

Usage:
    python -m nvblox_mindmap_torch.scripts.place_grounding_probe \
        --checkpoint tests/test_data/task_success/cube_stacking/last.ckpt \
        --scenes 10 --out place_grounding.json [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np


def probe_scene(model, bounds, emb, seed: int,
                num_vertices: int, cube_half: float = 0.04,
                max_policy_goals: int = 8) -> dict:
    """One scene: expert prefix through lift, then the policy's release.
    The policy runs on the model's device."""
    from nvblox_mindmap_torch.closed_loop.goals import is_goal_reached
    from nvblox_mindmap_torch.closed_loop.policies import (
        NvbloxDiffuserActorPolicy,
    )
    from nvblox_mindmap_torch.closed_loop.scripted import (
        make_cube_stacking_env, scripted_stack_goals,
    )
    from nvblox_mindmap_torch.scripts.task_success_experiment import (
        mapping_config,
    )

    env = make_cube_stacking_env(seed, num_cubes=2, cube_half=cube_half)
    policy = NvbloxDiffuserActorPolicy(
        model, emb, mapping_config("cube_stacking"),
        np.asarray(bounds), num_vertices_to_sample=num_vertices, seed=3,
        device=model.device,
    )
    env.reset()
    gt = scripted_stack_goals(env.initial_objects, cube_half)

    def run_to(goal) -> None:
        for _ in range(40):
            policy.step(env)
            env.step(goal)
            if is_goal_reached(
                emb, np.asarray(env.get_policy_state()), goal,
                is_intermediate_goal=False,
            ):
                break

    for g in gt[:4]:  # approach, descend, grasp, lift
        run_to(g)
    assert env.held_object_names(), f"scene {seed}: scripted grasp failed"

    release_xy: Optional[np.ndarray] = None
    n_goals = 0
    for _ in range(max_policy_goals):
        if release_xy is not None:
            break
        goals = policy.get_new_goal(env)
        if not goals:
            break
        for g in goals:
            g = np.asarray(g)
            n_goals += 1
            if g[7] < 0.5 and env.held_object_names():
                release_xy = g[:2].copy()
                break
            run_to(g)
    c1 = np.asarray(env.initial_objects["cube_1"][:2], dtype=np.float64)
    row = {
        "seed": seed,
        "cube_1_xy": c1.tolist(),
        "release_xy": None if release_xy is None else release_xy.tolist(),
        "release_error_m": (
            None if release_xy is None
            else float(np.linalg.norm(release_xy - c1))
        ),
        "policy_goals_until_release": n_goals,
    }
    return row


def _probe_humanoid_pick_scene(task: str, make_env, object_name: str,
                               container_name: str, object_key: str,
                               model, bounds, emb, seed: int,
                               num_vertices: int,
                               max_policy_goals: int = 8) -> dict:
    """One humanoid pick-place scene: information-free expert prefix (head
    sweep only), then the policy's intended PICK position.

    The humanoid tasks invert cube_stacking's probe geometry: their place
    target (the box/drum tray) is FIXED per scene while the object's spawn
    is randomized in a +/-0.1 m region
    (closed_loop/scripted.make_{drill_in_box,stick_in_bin}_env), so the
    perception-vs-prior question lives at the *pick*. The expert prefix
    is only the two head-sweep goals (staging hands, yaw overshoot +
    settle): the gripper history at hand-off holds scene-independent
    staging/rest positions, and everything the policy can know about the
    object's position is in the fused map. The first policy goal commanding
    a closed right hand before anything is held is where it intends to
    grasp; regressing that xy on the object's xy separates map-grounded
    picks (slope ~ 1) from a memorized dataset prior (slope ~ 0).
    """
    from nvblox_mindmap_torch.closed_loop.goals import is_goal_reached
    from nvblox_mindmap_torch.closed_loop.policies import (
        NvbloxDiffuserActorPolicy,
    )
    from nvblox_mindmap_torch.closed_loop.scripted import (
        scripted_humanoid_pick_place_goals,
    )
    from nvblox_mindmap_torch.scripts.task_success_experiment import (
        mapping_config,
    )

    env = make_env(seed)
    policy = NvbloxDiffuserActorPolicy(
        model, emb, mapping_config(task),
        np.asarray(bounds), num_vertices_to_sample=num_vertices, seed=3,
        device=model.device,
    )
    env.reset()
    obj = env.initial_objects[object_name][:3]
    box = env.initial_objects[container_name][:3]
    place = np.asarray([
        box[0], box[1],
        box[2] + env.object_half_map[container_name][2]
        + env.object_half_map[object_name][2],
    ])
    gt = scripted_humanoid_pick_place_goals(
        obj, place, env.initial_state[8:11], env.initial_state[0:3]
    )

    def run_to(goal) -> None:
        for _ in range(40):
            policy.step(env)
            env.step(goal)
            if is_goal_reached(
                emb, np.asarray(env.get_policy_state()), goal,
                is_intermediate_goal=False,
            ):
                break

    for g in gt[:2]:  # head sweep overshoot + settle: no object info leaks
        run_to(g)
    assert not env.held_object_names(), f"scene {seed}: prefix grasped?"

    # 17-dim humanoid goal layout (scripted._hgoal): right hand pos 8:11,
    # right closedness 15.
    pick_xy: Optional[np.ndarray] = None
    n_goals = 0
    for _ in range(max_policy_goals):
        if pick_xy is not None:
            break
        goals = policy.get_new_goal(env)
        if not goals:
            break
        for g in goals:
            g = np.asarray(g)
            n_goals += 1
            if g[15] >= 0.5 and not env.held_object_names():
                pick_xy = g[8:10].copy()
                break
            run_to(g)
    o = np.asarray(obj[:2], dtype=np.float64)
    return {
        "seed": seed,
        object_key: o.tolist(),
        "pick_xy": None if pick_xy is None else pick_xy.tolist(),
        "pick_error_m": (
            None if pick_xy is None else float(np.linalg.norm(pick_xy - o))
        ),
        "policy_goals_until_pick": n_goals,
    }


def probe_drill_pick_scene(model, bounds, emb, seed: int,
                           num_vertices: int,
                           max_policy_goals: int = 8) -> dict:
    from nvblox_mindmap_torch.closed_loop.scripted import make_drill_in_box_env

    return _probe_humanoid_pick_scene(
        "drill_in_box", make_drill_in_box_env, "power_drill", "open_box",
        "drill_xy", model, bounds, emb, seed, num_vertices,
        max_policy_goals,
    )


def probe_stick_pick_scene(model, bounds, emb, seed: int,
                           num_vertices: int,
                           max_policy_goals: int = 8) -> dict:
    from nvblox_mindmap_torch.closed_loop.scripted import make_stick_in_bin_env

    return _probe_humanoid_pick_scene(
        "stick_in_bin", make_stick_in_bin_env, "pick_up_object", "open_drum",
        "stick_xy", model, bounds, emb, seed, num_vertices,
        max_policy_goals,
    )


def summarize(rows: List[dict], target_key: str = "cube_1_xy",
              pred_key: str = "release_xy",
              err_key: str = "release_error_m") -> dict:
    ok = [r for r in rows if r[pred_key] is not None]
    out = {"num_scenes": len(rows), "num_released": len(ok)}
    if len(ok) >= 4:
        t = np.asarray([r[target_key] for r in ok])
        p = np.asarray([r[pred_key] for r in ok])
        for axis, name in ((0, "x"), (1, "y")):
            out[f"slope_{name}"] = float(np.polyfit(t[:, axis], p[:, axis], 1)[0])
            out[f"r_{name}"] = float(np.corrcoef(t[:, axis], p[:, axis])[0, 1])
        errs = np.asarray([r[err_key] for r in ok])
        out["median_release_error_m"] = float(np.median(errs))
        out["mean_release_error_m"] = float(errs.mean())
        out["release_spread_m"] = float(np.std(p, axis=0).mean())
    return out


_TASK_PROBE_KEYS = {
    # task -> (probe fn, regression target key, prediction key, error key)
    "cube_stacking": (probe_scene, "cube_1_xy", "release_xy",
                      "release_error_m"),
    "drill_in_box": (probe_drill_pick_scene, "drill_xy", "pick_xy",
                     "pick_error_m"),
    "stick_in_bin": (probe_stick_pick_scene, "stick_xy", "pick_xy",
                     "pick_error_m"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument(
        "--task", default="cube_stacking", choices=sorted(_TASK_PROBE_KEYS),
        help="cube_stacking regresses the policy's RELEASE on the support "
        "cube (the randomized place); drill_in_box / stick_in_bin regress "
        "the policy's PICK on the object spawn (their place trays are "
        "fixed per scene)",
    )
    ap.add_argument("--scenes", type=int, default=10)
    ap.add_argument(
        "--seed_base", type=int, default=9000,
        help="scene seeds seed_base..seed_base+scenes-1; keep disjoint from "
        "training (21+) and held-out (1234+) ranges",
    )
    ap.add_argument("--num_vertices", type=int, default=512)
    ap.add_argument("--out", default=None, help="write rows+summary JSON")
    ap.add_argument("--device", default=None,
                    help="device of the model and maps (default cuda; cpu to run "
                    "without a card)")
    args = ap.parse_args(argv)

    from nvblox_mindmap_torch.scripts.task_success_experiment import (
        _embodiment_for_task, flash_attention, load_model,
    )

    probe_fn, target_key, pred_key, err_key = _TASK_PROBE_KEYS[args.task]
    model, _, bounds = load_model(args.checkpoint, args.task, device=args.device)
    emb = _embodiment_for_task(args.task)
    rows = []
    for s in range(args.scenes):
        with flash_attention():
            row = probe_fn(
                model, bounds, emb, args.seed_base + s,
                num_vertices=args.num_vertices,
            )
        rows.append(row)
        pred = row[pred_key]
        print(
            f"scene {row['seed']}: target=({row[target_key][0]:+.3f},"
            f"{row[target_key][1]:+.3f}) pred="
            + ("NONE" if pred is None else
               f"({pred[0]:+.3f},{pred[1]:+.3f}) "
               f"err={row[err_key]:.3f} m")
        )
    summary = summarize(rows, target_key, pred_key, err_key)
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {"checkpoint": args.checkpoint, "rows": rows,
                 "summary": summary}, f, indent=1,
            )
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
