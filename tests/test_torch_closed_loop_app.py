"""Torch port vs the JAX package: the closed-loop app and what it stands on.

Goals, the kinematic and scene worlds, the box renderer, replayed frames,
scene.json worlds, the evaluators, the recorder, the ground-truth and
policy modes of ``apps/run_closed_loop_policy.py`` and
``apps/run_validate_demos.py``, each against the JAX package on the same
inputs (numpy seeds, or demos that the JAX package's ``generate_*_demos``
write at 64x64).

Tolerances: host numpy on both sides, so goals, states, renders, frames,
verdicts, summaries and eval files are equal exactly. The policy-mode app
integrates its own map, so there it is held as
``tests/test_torch_closed_loop.py`` holds the policy: before each goal the
port's map is checked against the JAX app's (``assert_states_match``) and
replaced by it, the port's model inputs are checked at 1e-5 and the JAX
batch and noise are fed to its sampler, and its goal is held at
``TRAJ_ATOL`` (1e-4); the episode then follows the JAX goal, so both apps
step one world along one trajectory.
"""
import os
import shutil
import types

import numpy as np
import pytest

import jax

from nvblox_mindmap_tpu.apps import run_closed_loop_policy as japp
from nvblox_mindmap_tpu.apps import run_validate_demos as jvalidate
from nvblox_mindmap_tpu.closed_loop import environment as jenv
from nvblox_mindmap_tpu.closed_loop import evaluators as jeval
from nvblox_mindmap_tpu.closed_loop import goals as jgoals
from nvblox_mindmap_tpu.closed_loop import policies as jpol
from nvblox_mindmap_tpu.closed_loop import runner as jrunner
from nvblox_mindmap_tpu.closed_loop import scene as jscene
from nvblox_mindmap_tpu.closed_loop import scripted as jscripted
from nvblox_mindmap_tpu.embodiments import registry as jregistry
from nvblox_mindmap_torch.apps import run_closed_loop_policy as tapp
from nvblox_mindmap_torch.apps import run_validate_demos as tvalidate
from nvblox_mindmap_torch.closed_loop import environment as tenv
from nvblox_mindmap_torch.closed_loop import evaluators as teval
from nvblox_mindmap_torch.closed_loop import goals as tgoals
from nvblox_mindmap_torch.closed_loop import policies as tpol
from nvblox_mindmap_torch.closed_loop import runner as trunner
from nvblox_mindmap_torch.closed_loop import scene as tscene
from nvblox_mindmap_torch.closed_loop import scripted as tscripted
from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
from nvblox_mindmap_torch.mapping.constants import MapperId
from nvblox_mindmap_torch.mapping.voxel_grid import state_from_numpy, state_to_numpy
from tests.test_torch_closed_loop import assert_batches_match
from tests.test_torch_mapping import assert_states_match
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    TRAJ_ATOL,
    jax_sampler_noise,
    one_torch_thread,
)

TASKS = ("cube_stacking", "mug_in_drawer", "drill_in_box", "stick_in_bin")
CUBE_HALF = 0.04
FIXTURE = os.path.join(os.path.dirname(__file__), "test_data", "task_success",
                       "cube_stacking", "last.ckpt")


def _generate(task, root):
    """One JAX-written demo of ``task`` at 64x64 (two for mug_in_drawer, as
    ``tests/test_task_success.py`` runs it)."""
    if task == "cube_stacking":
        return jscripted.generate_cube_stacking_demos(root, 1, seed=11, cube_half=CUBE_HALF)
    if task == "mug_in_drawer":
        return jscripted.generate_mug_in_drawer_demos(root, 2, seed=7)
    if task == "drill_in_box":
        return jscripted.generate_drill_in_box_demos(root, 1, seed=3)
    return jscripted.generate_stick_in_bin_demos(root, 1, seed=3)


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_demos")
    return {task: (str(root / task), _generate(task, str(root / task))) for task in TASKS}


def _embodiments(task):
    return make_embodiment_for_task(task), jregistry.make_embodiment_for_task(
        jregistry.Tasks(task))


# ------------------------------------------------------------------ goals


@pytest.mark.parametrize("task", ["cube_stacking", "drill_in_box"])
def test_goal_checks_and_intermediate_goals_match_jax(task):
    temb, jemb = _embodiments(task)
    rng = np.random.default_rng(0)
    size = temb.policy_state_size
    for trial in range(200):
        current = rng.normal(size=size).astype(np.float32)
        goal = current + rng.normal(size=size).astype(np.float32) * 10.0 ** rng.uniform(-4, 0)
        for q in (slice(3, 7), slice(11, 15)):
            if q.stop <= size:
                current[q] /= np.linalg.norm(current[q])
                goal[q] /= np.linalg.norm(goal[q])
        for inter, dist in ((False, None), (True, 0.05), (True, None)):
            assert (tgoals.is_goal_reached(temb, current, goal, inter, dist)
                    == jgoals.is_goal_reached(jemb, current, goal, inter, dist)), trial
        for dist in (None, 0.03, 0.2):
            out, out_flags = tgoals.add_intermediate_goals(temb, current, [goal, current], dist)
            ref, ref_flags = jgoals.add_intermediate_goals(jemb, current, [goal, current], dist)
            assert out_flags == ref_flags and len(out) == len(ref)
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(a, b)
        t = float(rng.uniform())
        np.testing.assert_array_equal(tgoals.slerp(current[3:7], goal[3:7], t),
                                      jgoals.slerp(current[3:7], goal[3:7], t))


# ------------------------------------------------------------------ worlds


def _assert_worlds_equal(tw, jw, what, cameras=True):
    np.testing.assert_array_equal(tw.get_robot_state(), jw.get_robot_state(), err_msg=what)
    np.testing.assert_array_equal(tw.get_policy_state(), jw.get_policy_state(), err_msg=what)
    tobj, jobj = tw.get_object_poses(), jw.get_object_poses()
    assert sorted(tobj) == sorted(jobj), what
    for name in jobj:
        np.testing.assert_array_equal(tobj[name], jobj[name], err_msg=f"{what} {name}")
    assert tw.is_success() == jw.is_success(), what
    if hasattr(jw, "held_object_names"):
        assert tw.held_object_names() == jw.held_object_names(), what
    if cameras:
        tcams, jcams = tw.get_cameras(), jw.get_cameras()
        assert sorted(tcams) == sorted(jcams), what
        for name in jcams:
            for field in ("rgb", "depth", "intrinsics", "pose7", "segmentation"):
                a, b = getattr(tcams[name], field), getattr(jcams[name], field)
                assert (a is None) == (b is None), (what, name, field)
                if b is not None:
                    assert np.asarray(a).dtype == np.asarray(b).dtype, (what, name, field)
                    np.testing.assert_array_equal(a, b, err_msg=f"{what} {name} {field}")
        assert tw.semantic_id_to_class == jw.semantic_id_to_class, what


def _step_both(tw, jw, goals, what, steps_per_goal=6, render_every=5):
    tw.reset()
    jw.reset()
    _assert_worlds_equal(tw, jw, f"{what} reset")
    k = 0
    for g, goal in enumerate(goals):
        for _ in range(steps_per_goal):
            tw.step(goal)
            jw.step(goal)
            k += 1
            _assert_worlds_equal(tw, jw, f"{what} goal {g} step {k}",
                                 cameras=k % render_every == 0)


def test_kinematic_world_matches_jax():
    for task, waypoints in (("cube_stacking", 3), ("drill_in_box", 2)):
        temb, jemb = _embodiments(task)
        rng = np.random.default_rng(1)
        size = temb.policy_state_size
        initial = rng.uniform(0.2, 0.6, size).astype(np.float32)
        goals = [initial + rng.normal(size=size).astype(np.float32) * 0.2 for _ in range(5)]
        for goal in goals:
            goal[7] = float(rng.uniform() > 0.5)
        wps = [g[:3] for g in goals[:waypoints]]
        objects = {"a": initial[:3] + 0.01, "b": np.asarray([0.5, 0.1, 0.3])}
        kw = dict(objects=objects, fixed_objects=["b"], image_size=16)
        _step_both(tenv.KinematicEnvironment(temb, initial, wps, **kw),
                   jenv.KinematicEnvironment(jemb, initial, wps, **kw), goals, task)


def test_scene_world_matches_jax():
    """The cube_stacking expert's goals in ``make_cube_stacking_env``: states,
    grasps, settled cubes and every fifth step's cameras equal."""
    for seed in (0, 5):
        tw = tscripted.make_cube_stacking_env(seed, num_cubes=3, cube_half=CUBE_HALF,
                                              image_size=32)
        jw = jscripted.make_cube_stacking_env(seed, num_cubes=3, cube_half=CUBE_HALF,
                                              image_size=32)
        goals = tscripted.scripted_stack_goals(tw.initial_objects, CUBE_HALF)
        ref = jscripted.scripted_stack_goals(jw.initial_objects, CUBE_HALF)
        assert len(goals) == len(ref)
        for a, b in zip(goals, ref):
            np.testing.assert_array_equal(a, b)
        _step_both(tw, jw, goals, f"scene seed {seed}")


def test_render_boxes_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    for trial in range(6):
        boxes_t, boxes_j = [], []
        for i in range(int(rng.integers(1, 6))):
            args = (f"box{i}", rng.uniform(-0.5, 0.5, 3), rng.uniform(0.01, 0.3, 3),
                    rng.uniform(0, 1, 3), int(rng.integers(0, 300)))
            boxes_t.append(tscene.Box(*args))
            boxes_j.append(jscene.Box(*args))
        eye = rng.uniform(-1.5, 1.5, 3)
        eye[2] = abs(eye[2]) + 0.3
        target = rng.uniform(-0.2, 0.2, 3)
        up = (0.0, 0.0, 1.0) if trial % 3 else (0.0, 0.0, -1.0)
        pose_t, pose_j = tscene.look_at_pose7(eye, target, up), jscene.look_at_pose7(eye, target, up)
        np.testing.assert_array_equal(pose_t, pose_j)
        H, W = (24, 40) if trial % 2 else (48, 48)
        K = np.asarray([[W * 0.9, 0, W / 2], [0, W * 0.9, H / 2], [0, 0, 1]], np.float32)
        out = tscene.render_boxes(boxes_t, pose_t, K, H, W)
        ref = jscene.render_boxes(boxes_j, pose_j, K, H, W)
        assert (out[1] > 0).any()
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # Looking straight down the up vector takes the arbitrary right axis.
    np.testing.assert_array_equal(tscene.look_at_pose7((0, 0, 1), (0, 0, 0)),
                                  jscene.look_at_pose7((0, 0, 1), (0, 0, 0)))


def test_replay_environment_frames_match_jax(demos):
    _, (demo,) = demos["cube_stacking"]
    temb, jemb = _embodiments("cube_stacking")
    tw = tenv.ReplayEnvironment(demo, temb, ["wrist"])
    jw = jenv.ReplayEnvironment(demo, jemb, ["wrist"])
    assert tw.num_frames == jw.num_frames > 10
    assert tw.semantic_id_to_class == jw.semantic_id_to_class and tw.semantic_id_to_class
    tw.reset()
    jw.reset()
    for t in range(tw.num_frames + 1):
        if t % 7 == 0 or tw.done:
            _assert_worlds_equal(tw, jw, f"frame {t}")
        assert tw.done == jw.done and tw.t == jw.t
        tw.step()
        jw.step()


@pytest.mark.parametrize("task", TASKS)
def test_env_from_scene_json_matches_jax(demos, task):
    """Each task's JAX-written scene.json rebuilds the same world: its spec,
    then the same states and renders along the demo's own GT keyposes."""
    _, dirs = demos[task]
    tw = tscripted.env_from_scene_json(dirs[0])
    jw = jscripted.env_from_scene_json(dirs[0])
    assert type(tw.embodiment).__name__ == type(jw.embodiment).__name__
    for name in ("initial_state", "head_position"):
        np.testing.assert_array_equal(getattr(tw, name), getattr(jw, name))
    for name in ("image_size", "grasp_radius_m", "fixed_objects", "robot_class_name",
                 "head_base_yaw", "head_look_distance_m", "head_look_z_m",
                 "max_head_yaw_step_rad", "focal_px", "object_half", "_is_humanoid"):
        assert getattr(tw, name) == getattr(jw, name), name
    for name in ("object_half_map", "object_colors", "initial_objects"):
        a, b = getattr(tw, name), getattr(jw, name)
        assert sorted(a) == sorted(b), name
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {key}")
    for t in (0, 3, 10**6):
        ta, ja = tw.camera_pose_fn(t), jw.camera_pose_fn(t)
        assert sorted(ta) == sorted(ja)
        for key in ja:
            np.testing.assert_array_equal(ta[key], ja[key])
    temb, jemb = _embodiments(task)
    extra = jregistry.TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS[jregistry.Tasks(task)]
    mode = jregistry.TASK_TO_KEYPOSE_DETECTION_MODE[jregistry.Tasks(task)]
    goals = jpol.GroundTruthPolicy.from_demo(dirs[0], jemb, extra, mode).goals
    _step_both(tw, jw, goals[:8], task, steps_per_goal=4, render_every=7)
    assert tscripted.env_from_scene_json(os.path.dirname(dirs[0])) is None


def test_scripted_recording_matches_jax(tmp_path):
    """The port's recorder writes the JAX recorder's demo: every .npy and
    the scene / label JSON equal, every PNG equal once decoded."""
    for pkg, root in ((tscripted, tmp_path / "port"), (jscripted, tmp_path / "jax")):
        env = pkg.make_cube_stacking_env(4, cube_half=CUBE_HALF, image_size=32)
        goals = pkg.scripted_stack_goals(env.initial_objects, CUBE_HALF)
        n = pkg.record_scripted_demo(str(root), env, goals)
        pkg.write_scene_json(str(root), env)
        assert n > 10
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert any(n.endswith("_semantic.png") for n in names)
    import imageio.v2 as imageio

    for name in names:
        out, ref = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(out), np.load(ref), err_msg=name)
        elif name.endswith(".png"):
            a, b = decode_png(str(out)), np.asarray(imageio.imread(ref))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert out.read_text() == ref.read_text(), name
    humanoid = tscene.SceneKinematicEnvironment(make_embodiment_for_task("drill_in_box"),
                                                np.zeros(17, np.float32), objects={})
    with pytest.raises(NotImplementedError, match="humanoid recorder"):
        tscripted.make_recorder(str(tmp_path / "h"), humanoid)


# ------------------------------------------------------------------ evaluators


class _PoseWorld:
    """Random object / gripper trajectories for the evaluators."""

    def __init__(self, rng, names, robot_dim):
        self.rng, self.names, self.robot_dim = rng, names, robot_dim
        self.poses = {n: np.concatenate([rng.uniform(-0.2, 0.6, 3), [1, 0, 0, 0]])
                      for n in names}
        self.robot = rng.uniform(0, 0.05, robot_dim)
        self.success = False

    def advance(self):
        for name in self.names:
            self.poses[name][:3] += self.rng.normal(size=3) * 0.06
        self.robot = np.clip(self.robot + self.rng.normal(size=self.robot_dim) * 0.02,
                             0, 1)
        self.success = bool(self.rng.uniform() < 0.05)

    def get_object_poses(self):
        return {k: v.copy() for k, v in self.poses.items()}

    def get_robot_state(self):
        return self.robot.copy()

    def get_policy_state(self):
        return self.robot[:8].copy()

    def is_success(self):
        return self.success


EVALUATORS = {
    "basic": (lambda m, p: m.BasicEvaluator(p), [], 9),
    "waypoint": (lambda m, p: m.WaypointEvaluator(
        [np.asarray([0.02, 0.03, 0.01]), np.asarray([0.3, 0.3, 0.3])], 0.2,
        eval_file_path=p), [], 9),
    "cube_stacking": (lambda m, p: m.make_evaluator_for_task(
        "cube_stacking", p, task_params={"num_cubes": 3, "cube_side_length": 0.08}),
        ["cube_1", "cube_2", "cube_3"], 9),
    "cube_stacking_policy_state": (lambda m, p: m.CubeStackingEvaluator(2, 0.3, p),
                                   ["cube_1", "cube_2"], 8),
    "mug_in_drawer": (lambda m, p: m.make_evaluator_for_task("mug_in_drawer", p),
                      ["target_mug", "bottom_of_drawer_with_mugs",
                       "bottom_of_drawer_with_boxes"], 9),
    "drill_in_box": (lambda m, p: m.make_evaluator_for_task("drill_in_box", p),
                     ["power_drill", "open_box"], 9),
    "stick_in_bin": (lambda m, p: m.make_evaluator_for_task("stick_in_bin", p),
                     ["pick_up_object", "open_drum"], 9),
    "no_object_state": (lambda m, p: m.make_evaluator_for_task(
        "cube_stacking", p, env_has_object_state=False), [], 9),
}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_evaluators_match_jax(name, tmp_path):
    """Three demos, two attempts each, over random object and gripper
    trajectories: step verdicts, finalized outcomes, summaries and the eval
    file's JSON equal."""
    make, objects, robot_dim = EVALUATORS[name]
    paths = {pkg: str(tmp_path / f"{pkg}.json") for pkg in ("port", "jax")}
    tev, jev = make(teval, paths["port"]), make(jeval, paths["jax"])
    assert type(tev).__name__ == type(jev).__name__
    rng = np.random.default_rng(sorted(EVALUATORS).index(name))
    for demo in range(3):
        for attempt in range(2):
            world = _PoseWorld(rng, objects, robot_dim)
            tev.start_demo(f"demo_{demo}", world, attempt)
            jev.start_demo(f"demo_{demo}", world, attempt)
            for _ in range(25):
                world.advance()
                tev.evaluate_step(world)
                jev.evaluate_step(world)
                assert tev.current_success == jev.current_success
            assert tev.finalize_demo(f"demo_{demo}", world) == jev.finalize_demo(
                f"demo_{demo}", world)
    assert tev.summarize_demos() == jev.summarize_demos()
    assert tev.success_rate() == jev.success_rate()
    with open(paths["port"]) as f, open(paths["jax"]) as g:
        assert f.read() == g.read()
    assert teval.object_in_box([0.1, 0, 0.05], [0, 0, 0]) == jeval.object_in_box(
        [0.1, 0, 0.05], [0, 0, 0])
    assert teval.object_in_drum([0.1, 0.5, 0.05], [0, 0, 0]) == jeval.object_in_drum(
        [0.1, 0.5, 0.05], [0, 0, 0])


# ------------------------------------------------------------------ policies, runner


def test_ground_truth_and_goal_policies_match_jax(demos):
    for task in TASKS:
        temb, jemb = _embodiments(task)
        jtask = jregistry.Tasks(task)
        extra = jregistry.TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS[jtask]
        mode = jregistry.TASK_TO_KEYPOSE_DETECTION_MODE[jtask]
        for demo in demos[task][1]:
            tp = tpol.GroundTruthPolicy.from_demo(demo, temb, extra, mode)
            jp = jpol.GroundTruthPolicy.from_demo(demo, jemb, extra, mode)
            assert len(tp.goals) == len(jp.goals) > 2
            while not jp.exhausted:
                out, ref = tp.get_new_goal(None), jp.get_new_goal(None)
                np.testing.assert_array_equal(out[0], ref[0])
            assert tp.exhausted and tp.get_new_goal(None) == []
    for etype in ("arm", "humanoid"):
        tp = tpol.get_dummy_policy_for_embodiment(tpol.EmbodimentType(etype))
        jp = jpol.get_dummy_policy_for_embodiment(jpol.EmbodimentType(etype))
        for _ in range(5):
            np.testing.assert_array_equal(tp.get_new_goal(None)[0], jp.get_new_goal(None)[0])
    once = tpol.GoalPolicy([np.zeros(8)], repeat=False)
    assert len(once.get_new_goal(None)) == 1 and once.get_new_goal(None) == []
    with pytest.raises(ValueError, match="embodiment"):
        tpol.get_dummy_policy_for_embodiment("wheeled")


def test_runner_matches_jax_in_the_kinematic_world():
    """Goal timeouts, intermediate goals and retries: the same episode
    verdicts, steps and summary."""
    for task in ("cube_stacking", "drill_in_box"):
        temb, jemb = _embodiments(task)
        rng = np.random.default_rng(3)
        size = temb.policy_state_size
        initial = rng.uniform(0.2, 0.6, size).astype(np.float32)
        goals = np.stack([initial + rng.normal(size=size).astype(np.float32) * 0.3
                          for _ in range(6)])
        for goal in goals:
            goal[3:7] = initial[3:7]
        summaries, trails = [], []
        for pkg, emb, env_mod, pol_mod, ev_mod in (
                (trunner, temb, tenv, tpol, teval),
                (jrunner, jemb, jenv, jpol, jeval)):
            trail = []
            config = pkg.ClosedLoopConfig(max_num_steps_to_goal=5, num_retries=2,
                                          max_intermediate_distance_m=0.1,
                                          terminate_after_n_steps=60)

            def make_env(demo, env_mod=env_mod, emb=emb, trail=trail):
                env = env_mod.KinematicEnvironment(emb, initial, [g[:3] for g in goals[:2]],
                                                   max_step_m=0.03)
                step = env.step
                env.step = lambda goal, step=step: (trail.append(
                    None if goal is None else np.array(goal)), step(goal))[1]
                return env

            summaries.append(pkg.run_closed_loop_policy(
                make_env, lambda demo, pol_mod=pol_mod: pol_mod.GroundTruthPolicy(goals), emb,
                ev_mod.BasicEvaluator(), ["a", "b"], config))
            trails.append(trail)
        assert summaries[0] == summaries[1]
        assert len(trails[0]) == len(trails[1]) > 10
        for a, b in zip(*trails):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ apps


@pytest.mark.parametrize("task", ["cube_stacking", "mug_in_drawer"])
def test_gt_closed_loop_app_matches_jax(demos, task, tmp_path, capsys):
    """``--demo_mode execute_gt_goals`` in the scene world: the same summary
    and eval file as the JAX app, and success (tests/test_task_success.py)."""
    root, dirs = demos[task]
    argv = ["--dataset", root, "--task", task, "--demos_closed_loop", f"0-{len(dirs) - 1}",
            "--demo_mode", "execute_gt_goals"]
    out = tapp.main(argv + ["--eval_file_path", str(tmp_path / "port.json"),
                            "--device", "cpu"], environment="scene")
    assert tapp.SUCCESS_SENTINEL in capsys.readouterr().out
    ref = japp.main(argv + ["--eval_file_path", str(tmp_path / "jax.json")],
                    environment="scene")
    assert out == ref
    assert out["num_demos"] == len(dirs) and out["success_rate"] == 1.0
    if task == "cube_stacking":
        assert out["mean_num_stacked_cubes"] >= 2.0
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_gt_app_in_replay_and_kinematic_worlds_matches_jax(demos, tmp_path):
    """The replay world (no object state: BasicEvaluator) and the kinematic
    world a demo without scene.json gets (GT keyposes as waypoints)."""
    root, (demo,) = demos["cube_stacking"]
    bare = tmp_path / "bare"
    shutil.copytree(demo, bare / "demo_00000")
    os.remove(bare / "demo_00000" / "scene.json")
    for environment, dataset in (("replay", root), ("kinematic", str(bare))):
        argv = ["--dataset", dataset, "--task", "cube_stacking", "--demos_closed_loop", "0",
                "--demo_mode", "gt", "--max_num_steps_to_goal", "20"]
        out = tapp.main(argv + ["--device", "cpu", "--eval_file_path",
                                str(tmp_path / f"{environment}_port.json")], environment)
        ref = japp.main(argv + ["--eval_file_path", str(tmp_path / f"{environment}_jax.json")],
                        environment)
        assert out == ref, environment
        assert ((tmp_path / f"{environment}_port.json").read_text()
                == (tmp_path / f"{environment}_jax.json").read_text())
    with pytest.raises(FileNotFoundError, match="scene.json"):
        tapp.main(["--dataset", str(bare), "--task", "cube_stacking", "--demo_mode", "gt",
                   "--device", "cpu"], environment="scene")


@pytest.mark.parametrize("flags", [[], ["--max_num_steps_to_goal", "1",
                                        "--terminate_after_n_steps", "4"]])
def test_validate_demos_app_matches_jax(demos, tmp_path, flags):
    """The same verdicts and outcome files (FAILED_GT_EVAL where a tight step
    budget cuts the GT keyposes short)."""
    results = {}
    for pkg, mod in (("port", tvalidate), ("jax", jvalidate)):
        root = tmp_path / pkg
        for task in ("cube_stacking", "drill_in_box"):
            src, _ = demos[task]
            shutil.copytree(src, root / task)
            argv = ["--task", task, "--dataset", str(root / task), "--demos_closed_loop", "0"]
            argv += flags + (["--device", "cpu"] if pkg == "port" else [])
            verdicts = mod.main(argv)
            results.setdefault(pkg, []).append(
                ({os.path.basename(k): v for k, v in verdicts.items()},
                 int(np.load(root / task / "demo_00000" / "demo_successful.npy"))))
    assert results["port"] == results["jax"]
    verdicts = [v["demo_00000"] for v, _ in results["port"]]
    assert [o for _, o in results["port"]] == [1 if v else -1 for v in verdicts]
    assert all(verdicts) if not flags else not all(verdicts)


def test_policy_mode_app_holds_to_jax(demos, tmp_path, monkeypatch):
    """The policy on the committed cube_stacking fixture through both apps
    (DDIM-10, ``--device cpu``), a short episode: per goal the maps, model
    inputs and goals as the module docstring says, then equal summaries and
    eval files."""
    root, _ = demos["cube_stacking"]
    argv = ["--dataset", root, "--task", "cube_stacking", "--demos_closed_loop", "0",
            "--checkpoint", FIXTURE, "--data_type", "mesh", "--feature_type", "rgb",
            "--embedding_dim", "72", "--fps_subsampling_factor", "4",
            "--diffusion_timesteps", "100", "--num_vertices_to_sample", "512",
            "--image_size", "64,64", "--voxel_size_m", "0.02", "--seed", "3",
            "--serving_scheduler", "ddim", "--serving_num_inference_steps", "10",
            "--max_num_steps_to_goal", "3", "--terminate_after_n_steps", "8"]
    records, port_goals = [], []
    jget = jpol.NvbloxDiffuserActorPolicy.get_new_goal

    def record(self, env):
        key = jax.random.split(self._key)[1]
        # A host copy: the JAX mapper donates its state's buffers.
        state = types.SimpleNamespace(**state_to_numpy(self.mapper.states[MapperId.STATIC]))
        inputs = []
        own = self._model_inputs
        self._model_inputs = lambda e: inputs.append(own(e)) or inputs[-1]
        goals = jget(self, env)
        del self._model_inputs
        records.append((state, inputs[-1], goals, key))
        return goals

    monkeypatch.setattr(jpol.NvbloxDiffuserActorPolicy, "get_new_goal", record)
    ref = japp.main(argv + ["--eval_file_path", str(tmp_path / "jax.json")], "scene")
    assert len(records) >= 2

    tget = tpol.NvbloxDiffuserActorPolicy.get_new_goal

    def replay(self, env, init_noise=None, step_noise=None):
        jstate, jbatch, jgoals, key = records[len(port_goals)]
        assert_states_match(self.mapper.states[MapperId.STATIC], jstate,
                            f"app map before goal {len(port_goals)}")
        self.mapper.states[MapperId.STATIC] = state_from_numpy(vars(jstate), device="cpu")
        own = self._model_inputs
        self._model_inputs = lambda e: (assert_batches_match(own(e), jbatch), jbatch)[1]
        init, steps = jax_sampler_noise(key, 10, (1, 1, 1))
        goals = tget(self, env, init, steps)
        del self._model_inputs
        assert len(goals) == len(jgoals) == 1
        np.testing.assert_allclose(goals[0], jgoals[0], atol=TRAJ_ATOL, rtol=0)
        port_goals.append(goals)
        return jgoals

    monkeypatch.setattr(tpol.NvbloxDiffuserActorPolicy, "get_new_goal", replay)
    out = tapp.main(argv + ["--eval_file_path", str(tmp_path / "port.json"),
                            "--device", "cpu"], "scene")
    assert len(port_goals) == len(records)
    assert out == ref
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
