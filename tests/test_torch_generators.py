"""Torch port vs the JAX package: the demo-set generators and the humanoid
recorder of ``closed_loop/scripted.py``.

Each generator of the port writes, from the same seed, the demo the JAX
package's generator writes: the same file names, every ``.npy`` (robot
states, poses, intrinsics, outcome) equal, every PNG equal once decoded
(the port's decoder on its files, imageio on the JAX files), and equal
``scene.json`` / ``semantic_labels.json`` text. Held for one 64x64 demo of
each of the four tasks (seed 21, the task-success experiment's), the
cube_stacking slip-and-recover demo, and DAgger harvests driven by a
``GoalPolicy`` of each package (the scenarios of ``tests/test_dagger.py``:
a drifting policy whose release is intercepted, a wandering one stopped by
its goal budget). Host numpy on both sides, so everything is exact.
"""
import os

import imageio.v2 as imageio
import numpy as np
import pytest

from nvblox_mindmap_tpu.closed_loop import policies as jpol
from nvblox_mindmap_tpu.closed_loop import scripted as jscripted
from nvblox_mindmap_torch.closed_loop import policies as tpol
from nvblox_mindmap_torch.closed_loop import scripted as tscripted
from nvblox_mindmap_torch.data.dataset import DemoDataset
from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task

TASKS = ("cube_stacking", "mug_in_drawer", "drill_in_box", "stick_in_bin")
SEED = 21  # the training scenes of scripts/task_success_experiment.py
CUBE_HALF = 0.04
DAGGER_SEED = 311  # tests/test_dagger.py


# The files that fusing a demo adds to it.
FUSED = (".nvblox_vertex_features.zst", "demo_successful.npy")


def assert_demos_equal(port_dir, jax_dir, fused=False):
    """``fused``: the port's demo has been fused since it was written, and
    the files fusion added are not compared."""
    names = sorted(os.listdir(jax_dir))
    port_names = sorted(os.listdir(port_dir))
    if fused:
        port_names = [n for n in port_names if n in names or not n.endswith(FUSED)]
    assert port_names == names
    assert any(n.endswith("_semantic.png") for n in names)
    for name in names:
        out, ref = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(out), np.load(ref), err_msg=name)
        elif name.endswith(".png"):
            a, b = decode_png(out), np.asarray(imageio.imread(ref))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            with open(out) as f, open(ref) as g:
                assert f.read() == g.read(), name


def _generate(pkg, task, root):
    kwargs = {"cube_half": CUBE_HALF} if task == "cube_stacking" else {}
    return getattr(pkg, f"generate_{task}_demos")(root, 1, seed=SEED, image_size=64, **kwargs)


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    root = tmp_path_factory.mktemp("generated")
    return {task: {name: _generate(pkg, task, str(root / name / task))[0]
                   for name, pkg in (("port", tscripted), ("jax", jscripted))}
            for task in TASKS}


@pytest.mark.parametrize("task", TASKS)
def test_generator_writes_the_jax_demo(demos, task):
    assert_demos_equal(demos[task]["port"], demos[task]["jax"])
    env = tscripted.env_from_scene_json(demos[task]["port"])
    assert type(env.embodiment) is type(make_embodiment_for_task(task))


def test_humanoid_demo_has_head_turn_keyposes(demos):
    """The port's drill demo: 37-dim states, grasp intervals for the right
    hand only, and head-turn keyposes under the GR1 detection mode
    (``tests/test_humanoid_tasks.py::test_drill_demo_has_head_turn_keyposes``)."""
    emb = HumanoidEmbodiment()
    states = DemoDataset.load_robot_states(demos["drill_in_box"]["port"])
    assert states.shape[1] == 37
    (left_iv, _), (right_iv, _) = emb.get_grasp_events(states)
    assert left_iv == []
    assert len(right_iv) == 2  # grasp + release
    base = emb.extract_keypose_indices(
        states, [5, 15], KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION)
    with_turns = emb.extract_keypose_indices(
        states, [5, 15], KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN)
    assert len(with_turns) > len(base), "head-turn mode added no keyposes"


def test_make_recorder_dispatches_by_embodiment(tmp_path):
    arm = tscripted.make_cube_stacking_env(0, image_size=16)
    humanoid = tscripted.make_stick_in_bin_env(0, image_size=16)
    assert isinstance(tscripted.make_recorder(str(tmp_path / "a"), arm),
                      tscripted.ArmDemoRecorder)
    assert isinstance(tscripted.make_recorder(str(tmp_path / "h"), humanoid),
                      tscripted.HumanoidDemoRecorder)


def test_recovery_demo_matches_jax(tmp_path):
    dirs = {}
    for name, pkg in (("port", tscripted), ("jax", jscripted)):
        dirs[name] = pkg.generate_cube_stacking_recovery_demos(
            str(tmp_path / name), 1, seed=SEED + 1000, cube_half=CUBE_HALF, start_index=8)
    assert os.path.basename(dirs["port"][0]) == "demo_00008"
    assert_demos_equal(dirs["port"][0], dirs["jax"][0])


def _goal(pos, closed):
    return np.concatenate([np.asarray(pos, np.float32), [0, 1, 0, 0], [np.float32(closed)]])


def _dagger_policy(pkg, kind):
    """``tests/test_dagger.py``'s drifting and wandering policies."""
    env = tscripted.make_cube_stacking_env(DAGGER_SEED, num_cubes=2, cube_half=CUBE_HALF)
    pick = env.initial_objects["cube_2"][:3]
    place = env.initial_objects["cube_1"][:3] + [0, 0, 2 * CUBE_HALF]
    if kind == "drifting":
        bad = place + np.asarray([0.15, 0.08, 0.0])
        goals = [_goal([pick[0], pick[1], 0.22], 0.0), _goal(pick, 0.0), _goal(pick, 1.0),
                 _goal([pick[0], pick[1], 0.22], 1.0), _goal([bad[0], bad[1], 0.22], 1.0),
                 _goal(bad, 1.0), _goal(bad, 0.0)]
        return lambda: pkg.GoalPolicy(goals, repeat=False)
    goals = [_goal([0.5, 0.15, 0.25], 0.0), _goal([0.45, -0.15, 0.2], 0.0),
             _goal([0.55, 0.0, 0.3], 0.0)]
    return lambda: pkg.GoalPolicy(goals, repeat=True)


@pytest.mark.parametrize("kind,budget,reason", [
    ("drifting", (20, 21), "release_intercepted"),
    ("wandering", (2, 3), "goal_budget"),
])
def test_dagger_harvest_matches_jax(tmp_path, kind, budget, reason):
    out = {}
    for name, pkg, pol in (("port", tscripted, tpol), ("jax", jscripted, jpol)):
        out[name] = pkg.generate_cube_stacking_dagger_demos(
            str(tmp_path / name), 1, _dagger_policy(pol, kind), seed=DAGGER_SEED,
            cube_half=CUBE_HALF, policy_goal_budget_range=budget)
    (port_dirs, port_stats), (jax_dirs, jax_stats) = out["port"], out["jax"]
    assert port_stats == jax_stats
    assert port_stats[0]["stop_reason"] == reason
    assert 0 < port_stats[0]["policy_frames"] < port_stats[0]["total_frames"]
    assert_demos_equal(port_dirs[0], jax_dirs[0])
    # The recording's keyposes reach the pick and the expert's place.
    states = DemoDataset.load_robot_states(port_dirs[0])
    idx = ArmEmbodiment().extract_keypose_indices(
        states, extra_keyposes_around_grasp_events=[],
        keypose_detection_mode=KeyposeDetectionMode.HIGHEST_Z_BETWEEN_GRASP)
    env = tscripted.make_cube_stacking_env(DAGGER_SEED, num_cubes=2, cube_half=CUBE_HALF)
    pick = env.initial_objects["cube_2"][:3]
    place = env.initial_objects["cube_1"][:3] + [0, 0, 2 * CUBE_HALF]
    kp = states[idx][:, :3]
    assert np.min(np.linalg.norm(kp - pick, axis=1)) < 0.05
    assert np.min(np.linalg.norm(kp - place, axis=1)) < 0.05


def test_completion_goals_match_jax():
    """The expert's takeover plan from a state where the base cube is held
    (``tests/test_dagger.py::test_completion_goals_put_down_held_base_cube_then_restack``),
    then from the initial state, equals the JAX expert's."""
    plans = {}
    for name, pkg in (("port", tscripted), ("jax", jscripted)):
        env = pkg.make_cube_stacking_env(DAGGER_SEED, num_cubes=2, cube_half=CUBE_HALF)
        env.reset()
        first = pkg.scripted_completion_goals(env, CUBE_HALF)
        base0 = env.initial_objects["cube_1"][:3].copy()
        for g in [_goal(base0, 0.0), _goal(base0, 1.0), _goal([0.6, 0.18, 0.2], 1.0)]:
            for _ in range(40):
                env.step(g)
                if np.linalg.norm(env.get_policy_state()[:3] - g[:3]) < 0.01:
                    break
        assert env.held_object_names() == ["cube_1"]
        plans[name] = first + pkg.scripted_completion_goals(env, CUBE_HALF)
    assert len(plans["port"]) == len(plans["jax"])
    for a, b in zip(plans["port"], plans["jax"]):
        np.testing.assert_array_equal(a, b)
