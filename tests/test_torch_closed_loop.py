"""Torch port vs the JAX package: the closed-loop policy.

``NvbloxDiffuserActorPolicy`` of both packages runs in the JAX package's
hermetic scene world (``SceneKinematicEnvironment``, 64x64 cameras) with a
committed task-success checkpoint, loaded into the port through its weight
bridge, and the mapping config of ``scripts/task_success_experiment.py``
(2 cm voxels, RGB features). Both take the same sim steps; then their maps,
their model inputs and their goals are compared. The port's sampler noise
is the JAX policy's own: its key sequence (one split per goal) through
``jax_sampler_noise``.

Each package integrates its own map; before each goal the port then takes
the JAX map (``state_from_numpy``), and at the goal the port's own model
inputs are held to the JAX policy's, which its sampler then takes. Two
discontinuities make that split necessary:

- vertex features from maps integrated apart differ by up to 1e-3
  (``tests/test_torch_mapping.py``);
- inputs equal to ~6e-8 (XLA fuses the voxel-centre and crossing
  arithmetic into FMAs) still move a goal by ~1e-3 (measured 1.0e-3 and
  2.0e-3 on drill_in_box): feature-space FPS picks among near-equal
  candidates, and an ulp flips the pick.

Tolerances: maps as in ``tests/test_torch_mapping.py`` (page bookkeeping
exact; fp32 fields 1e-5, fp16 pools 1e-3, on all but 0.1% of entries);
model inputs 1e-5 (vertices, features, point clouds; the gripper history
exact); goals 1e-4 (``tests/test_torch_model_parity.py``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from nvblox_mindmap_tpu.closed_loop import policies as jpol
from nvblox_mindmap_tpu.closed_loop import scripted
from nvblox_mindmap_tpu.embodiments import registry
from nvblox_mindmap_tpu.embodiments.arm import ArmEmbodiment as JaxArm
from nvblox_mindmap_tpu.embodiments.humanoid import HumanoidEmbodiment as JaxHumanoid
from nvblox_mindmap_tpu.mapping.constants import get_workspace_bounds
from nvblox_mindmap_tpu.models.diffuser_actor import DiffuserActor as JaxDiffuserActor
from nvblox_mindmap_tpu.scripts import task_success_experiment as exp
from nvblox_mindmap_torch.closed_loop import policies as tpol
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
from nvblox_mindmap_torch.mapping.constants import MappingConfig, MapperId
from nvblox_mindmap_torch.mapping.voxel_grid import state_from_numpy, state_to_numpy
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models.weights import load_flax_params
from tests.test_torch_fixture_parity import fixture_configs, load_params
from tests.test_torch_mapping import assert_states_match
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    TRAJ_ATOL,
    jax_sampler_noise,
    one_torch_thread,
)

N_VERTICES = 512
SEED = 3
# (make_env, humanoid) per committed fixture.
TASKS = {
    "cube_stacking": (scripted.make_cube_stacking_env, False),
    "drill_in_box": (scripted.make_drill_in_box_env, True),
}
# JAX policy kwargs per sampler; the port's take the same names.
SAMPLERS = {
    "ddpm100": dict(scheduler_kind="ddpm", stochastic_sampling=True),
    "ddim10": dict(num_inference_steps=10, scheduler_kind="ddim", stochastic_sampling=False),
}


def port_mapping_config(task):
    return MappingConfig(**dataclasses.asdict(exp.mapping_config(task)))


def policies(task, sampler, **extra):
    """(JAX policy, port policy) on the task's fixture."""
    _, humanoid = TASKS[task]
    params = load_params(f"task_success/{task}/last.ckpt")
    jcfg, tcfg = fixture_configs(humanoid)
    tmodel = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(tmodel, params)
    bounds = get_workspace_bounds(registry.Tasks(task))
    kw = dict(num_vertices_to_sample=N_VERTICES, seed=SEED, **SAMPLERS[sampler], **extra)
    jp = jpol.NvbloxDiffuserActorPolicy(
        JaxDiffuserActor(jcfg), params, registry.make_embodiment_for_task(registry.Tasks(task)),
        exp.mapping_config(task), bounds, **kw)
    tp = tpol.NvbloxDiffuserActorPolicy(
        tmodel, make_embodiment_for_task(task), port_mapping_config(task), bounds,
        device="cpu", **kw)
    return jp, tp


def assert_batches_match(tb, jb):
    assert sorted(tb) == sorted(jb)
    for name, ref in jb.items():
        out = tb[name]
        assert (out is None) == (ref is None), name
        if ref is None:
            continue
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        ref = np.asarray(ref)
        assert out.shape == ref.shape and out.dtype == ref.dtype, name
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("task,sampler,samples", [
    ("cube_stacking", "ddpm100", 1),
    ("cube_stacking", "ddim10", 3),
    ("drill_in_box", "ddpm100", 1),
    ("drill_in_box", "ddim10", 1),
])
def test_policy_matches_jax_in_scene_world(task, sampler, samples):
    """Sim steps, then a goal, twice: the maps, the model inputs and the
    goals match (``samples`` > 1: consensus goals)."""
    make_env, humanoid = TASKS[task]
    extra = dict(num_prediction_samples=samples)
    if task == "drill_in_box" and sampler == "ddim10":
        extra["timestep_spacing"] = "trailing"  # the fixture's serving config
    jp, tp = policies(task, sampler, **extra)
    env = make_env(0)
    env.reset()
    steps = len(tp.model.config.schedules()[0].timesteps(
        tp.sampler["num_inference_steps"], spacing=tp.sampler["timestep_spacing"]))
    G = 2 if humanoid else 1
    key = jax.random.PRNGKey(SEED)
    goal = None
    jax_inputs = []
    jax_model_inputs, port_model_inputs = jp._model_inputs, tp._model_inputs
    jp._model_inputs = lambda env: jax_inputs.append(jax_model_inputs(env)) or jax_inputs[-1]

    def port_inputs(env):
        assert_batches_match(port_model_inputs(env), jax_inputs[-1])
        return jax_inputs[-1]

    tp._model_inputs = port_inputs
    for i in range(2):
        for _ in range(2):
            jp.step(env)
            tp.step(env)
            env.step(goal)
        jmap = jp.mapper.states[MapperId.STATIC]
        assert_states_match(tp.mapper.states[MapperId.STATIC], jmap, f"{task} map before goal {i}")
        tp.mapper.states[MapperId.STATIC] = state_from_numpy(state_to_numpy(jmap), device="cpu")
        key, sub = jax.random.split(key)
        init, step_noise = jax_sampler_noise(sub, steps, (samples, 1, G))
        jgoals = jp.get_new_goal(env)
        tgoals = tp.get_new_goal(env, init, step_noise)
        assert len(jax_inputs) == i + 1
        assert tp.mapper.last_crossing_count == jp.mapper.last_crossing_count > N_VERTICES
        assert len(tgoals) == len(jgoals) == 1
        assert tgoals[0].shape == ((17,) if humanoid else (8,))
        np.testing.assert_allclose(tgoals[0], jgoals[0], atol=TRAJ_ATOL, rtol=0)
        goal = tgoals[0]


def test_aggregate_and_policy_states_match_jax():
    rng = np.random.default_rng(0)
    for K, L, G in ((5, 2, 1), (3, 1, 2), (1, 1, 1)):
        traj = rng.normal(size=(K, L, G, 8)).astype(np.float32)
        traj[..., 7] = rng.uniform(size=(K, L, G))
        yaw = rng.normal(size=(K, L, 1)).astype(np.float32)
        for head_yaw in (yaw, None):
            out, out_yaw = tpol.aggregate_trajectory_samples(traj, head_yaw)
            ref, ref_yaw = jpol.aggregate_trajectory_samples(traj, head_yaw)
            np.testing.assert_array_equal(out, ref)
            assert (out_yaw is None) == (ref_yaw is None)
            if out_yaw is not None:
                np.testing.assert_array_equal(out_yaw, ref_yaw)
            if G == 1:
                pairs = ((ArmEmbodiment(), JaxArm()),)
            else:
                pairs = ((HumanoidEmbodiment(), JaxHumanoid()),)
            for temb, jemb in pairs:
                for a, b in zip(tpol.trajectory_to_policy_states(out, out_yaw, temb),
                                jpol.trajectory_to_policy_states(ref, ref_yaw, jemb)):
                    np.testing.assert_array_equal(a, b)


def test_embodiment_codecs_match_jax():
    rng = np.random.default_rng(1)
    for task in registry.Tasks:
        temb = make_embodiment_for_task(task.value)
        jemb = registry.make_embodiment_for_task(task)
        assert temb.embodiment_type.value == jemb.embodiment_type.value
        assert (temb.num_grippers, temb.policy_state_size) == (jemb.num_grippers,
                                                               jemb.policy_state_size)
        states = rng.normal(size=(2, 3, temb.policy_state_size)).astype(np.float32)
        np.testing.assert_array_equal(temb.split_gripper_tensor(states),
                                      jemb.split_gripper_tensor(states))
        yaw, ref = temb.split_head_yaw_tensor(states), jemb.split_head_yaw_tensor(states)
        assert (yaw is None) == (ref is None)
        if yaw is not None:
            np.testing.assert_array_equal(yaw, ref)
    with pytest.raises(ValueError, match="8-d"):
        ArmEmbodiment().split_gripper_tensor(np.zeros((1, 3, 17), np.float32))


class _FakeMapper:
    """Reports 6300 crossings (a humanoid scene at the default budget)."""

    def __init__(self, calls):
        self.calls = calls
        self.last_crossing_count = 0

    def update_feature_mesh(self, mapper_id, max_vertices):
        self.calls.append(max_vertices)
        self.last_crossing_count = 6300


@pytest.mark.parametrize("package", ["jax", "port"])
def test_mesh_budget_grows_to_fit_scene(package):
    """The budget doubles until the crossings fit, persists, and stops at
    the 65536 cap (truncation by linear index beyond it), in both packages."""
    cls = (jpol if package == "jax" else tpol).NvbloxDiffuserActorPolicy
    pol = cls.__new__(cls)
    calls = []
    pol.mapper = _FakeMapper(calls)
    pol._mesh_budget = 4096
    pol._extract_mesh_growing(0)
    assert calls == [4096, 8192] and pol._mesh_budget == 8192
    pol._extract_mesh_growing(0)
    assert calls[-1] == 8192
    pol._mesh_budget = 32768
    pol.mapper.update_feature_mesh = lambda mapper_id, max_vertices: (
        calls.append(max_vertices), setattr(pol.mapper, "last_crossing_count", 10**6))
    pol._extract_mesh_growing(0)
    assert calls[-2:] == [32768, 65536] and pol._mesh_budget == 65536


def test_policy_checks_feature_dim_device_and_rgbd_skips_the_map():
    _, tcfg = fixture_configs(False)
    model = tda.DiffuserActor(tcfg, device="cpu")
    bounds = get_workspace_bounds(registry.Tasks.CUBE_STACKING)
    mcfg = port_mapping_config("cube_stacking")
    with pytest.raises(ValueError, match="8-d"):
        tpol.NvbloxDiffuserActorPolicy(model, ArmEmbodiment(),
                                       dataclasses.replace(mcfg, feature_dim=8), bounds,
                                       device="cpu")
    with pytest.raises(ValueError, match="the model is on cpu"):
        tpol.NvbloxDiffuserActorPolicy(model, ArmEmbodiment(), mcfg, bounds, device="meta")
    rgbd = tda.DiffuserActor(dataclasses.replace(tcfg, data_type="rgbd",
                                                 feature_image_size=(4, 4)), device="cpu")
    pol = tpol.NvbloxDiffuserActorPolicy(rgbd, ArmEmbodiment(), mcfg, bounds,
                                         num_inference_steps=2, scheduler_kind="ddim",
                                         stochastic_sampling=False, device="cpu")
    env = scripted.make_cube_stacking_env(1)
    env.reset()
    pol.step(env)
    assert float(pol.mapper.states[MapperId.STATIC].weight.max()) == 0.0
    goals = pol.get_new_goal(env)
    assert len(goals) == 1 and goals[0].shape == (8,) and np.isfinite(goals[0]).all()


@pytest.mark.slow
def test_port_policy_closed_loop_task_success(tmp_path):
    """The port's policy through the port's own closed-loop runner, scene
    world (rebuilt from the JAX-written scene.json) and evaluator on 4
    cube_stacking scenes with the committed fixture: the bar of
    ``tests/test_task_success.py::test_trained_policy_closed_loop_task_success``
    (success in at least one scene, DDPM-100 as the reference protocol)."""
    from nvblox_mindmap_torch.closed_loop.evaluators import make_evaluator_for_task
    from nvblox_mindmap_torch.closed_loop.runner import ClosedLoopConfig, run_closed_loop_policy
    from nvblox_mindmap_torch.closed_loop.scripted import env_from_scene_json

    task = "cube_stacking"
    exp._generator_for_task(task)(str(tmp_path / "ds"), 8, 21)
    params = load_params(f"task_success/{task}/last.ckpt")
    _, tcfg = fixture_configs(False)
    model = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(model, params)
    bounds = get_workspace_bounds(registry.Tasks(task))

    def make_policy(demo_path):
        return tpol.NvbloxDiffuserActorPolicy(
            model, make_embodiment_for_task(task), port_mapping_config(task), bounds,
            num_vertices_to_sample=N_VERTICES, seed=SEED, device="cpu")

    demos = [os.path.join(str(tmp_path / "ds"), f"demo_{i:05d}") for i in range(4)]
    evaluator = make_evaluator_for_task(
        task, task_params={"num_cubes": 2, "cube_side_length": 2 * exp.CUBE_HALF})
    summary = run_closed_loop_policy(
        env_from_scene_json, make_policy, make_embodiment_for_task(task), evaluator,
        demo_names=demos,
        config=ClosedLoopConfig(max_num_steps=220, max_num_steps_to_goal=30, num_retries=2))
    print(summary)
    assert summary["num_demos"] == 4
    assert summary["success_rate"] > 0, summary
