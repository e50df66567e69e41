"""The port's spans (``utils/timers.span``) on the profiler's timeline.

With no profile recording, ``span`` is one shared no-op and the policy
leaves the timer registry as it found it. Under ``ProfilerTrace`` the
closed-loop policy (the committed cube_stacking fixture, and an
rgbd_and_mesh model for the image phases) and a train step (without and
with a process group) write their phases as ``mindmap/`` ranges, each child
inside its parent; the goal's trajectory and the train step's losses are
bit-equal with and without the profiler.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from nvblox_mindmap_torch.closed_loop import policies as tpol
from nvblox_mindmap_torch.closed_loop.scripted import make_cube_stacking_env
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models.weights import load_flax_params
from nvblox_mindmap_torch.scripts.task_success_experiment import mapping_config
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils import timers
from tests.test_torch_fixture_parity import fixture_configs, load_params
from tests.test_torch_image_path import make_image_batch
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    BOUNDS,
    one_torch_thread,
)

STEPS = 3  # DDIM steps of the goal
STEP_SPANS = ("policy/step", "policy/step/features", "policy/step/integrate", "mapper/decay",
              "mapper/depth", "mapper/color", "mapper/features")
GOAL_SPANS = ("policy/goal", "policy/goal/mesh", "mapper/mesh", "mapper/mesh_to_host",
              "policy/goal/sample_vertices", "policy/goal/predict", "model/prepare_inputs",
              "model/encode", "encoder/fps", "sampler/step")
IMAGE_SPANS = ("policy/goal/camera_inputs", "encoder/backbone")
TRAIN_SPANS = ("trainer/step", "trainer/loss_and_grads", "trainer/optimizer",
               "model/prepare_inputs", "model/encode", "encoder/backbone", "encoder/fps")


def policy(data_type):
    """A DDIM policy on cube_stacking: the committed fixture (mesh), or an
    rgbd_and_mesh model of its widths with seeded weights."""
    _, tcfg = fixture_configs(False)
    if data_type == "mesh":
        model = tda.DiffuserActor(tcfg, device="cpu")
        load_flax_params(model, load_params("task_success/cube_stacking/last.ckpt"))
    else:
        torch.manual_seed(0)
        model = tda.DiffuserActor(dataclasses.replace(tcfg, data_type=data_type,
                                                      feature_image_size=(8, 8)), device="cpu")
    return tpol.NvbloxDiffuserActorPolicy(
        model, ArmEmbodiment(), mapping_config("cube_stacking"),
        get_workspace_bounds("cube_stacking"), num_vertices_to_sample=128, seed=3,
        num_inference_steps=STEPS, scheduler_kind="ddim", stochastic_sampling=False,
        device="cpu")


def step_and_goal(pol):
    """One sim step and one goal; (the goal's trajectory, the goal)."""
    env = make_cube_stacking_env(1)
    env.reset()
    trajs = []
    predict = pol.predict

    def recording(*args, **kwargs):
        out = predict(*args, **kwargs)
        trajs.append(out[0])
        return out

    pol.predict = recording
    pol.step(env)
    noise = torch.randn((1, 1, 1, 9), generator=torch.Generator().manual_seed(0))
    goal = pol.get_new_goal(env, init_noise=noise)
    return trajs[0], goal


def spans(trace_path):
    """{name after the prefix: sorted [(start, end)]} of the trace's spans."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(timers.SPAN_PREFIX):
            out.setdefault(name[len(timers.SPAN_PREFIX):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return {k: sorted(v) for k, v in out.items()}


def inside(child, parents):
    return all(any(lo <= a and b <= hi for lo, hi in parents) for a, b in child)


def test_span_off_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert timers.span("policy/goal") is timers.span("sampler/step") is timers._NO_SPAN
    with timers.span("policy/goal") as entered:
        assert entered is None
    before = timers.timer_status_string()
    step_and_goal(policy("mesh"))
    assert timers.timer_status_string() == before


@pytest.mark.parametrize("data_type", ["mesh", "rgbd_and_mesh"])
def test_policy_spans_nest_and_leave_the_goal_unchanged(tmp_path, data_type):
    plain_traj, plain_goal = step_and_goal(policy(data_type))
    with timers.ProfilerTrace(str(tmp_path)) as trace:
        traj, goal = step_and_goal(policy(data_type))
    assert np.array_equal(traj, plain_traj)
    assert all(np.array_equal(a, b) for a, b in zip(goal, plain_goal))

    found = spans(trace.path)
    expected = STEP_SPANS + GOAL_SPANS + (IMAGE_SPANS if data_type != "mesh" else ())
    assert set(expected) <= set(found)
    assert (data_type == "mesh") == (not set(IMAGE_SPANS) & set(found))
    assert len(found["policy/goal"]) == len(found["policy/step"]) == 1
    assert len(found["sampler/step"]) == STEPS
    assert inside(found["sampler/step"], found["policy/goal/predict"])
    assert inside(found["policy/goal/predict"], found["policy/goal"])
    assert inside(found["mapper/features"], found["policy/step/integrate"])
    assert inside(found["policy/step/integrate"], found["policy/step"])
    assert inside(found["mapper/mesh"], found["policy/goal/mesh"])


def train_two_steps():
    """Two steps of a tiny rgbd_and_mesh trainer; their losses."""
    _, tcfg = fixture_configs(False)
    cfg = dataclasses.replace(tcfg, data_type="rgbd_and_mesh", feature_image_size=(4, 4))
    batch = make_image_batch(np.random.default_rng(0), 2, 1, 16, BOUNDS, n_vertices=16)
    batch["gt_gripper_pred"] = batch["gripper_history"][:, -1:]
    trainer = Trainer(cfg, TrainerConfig(batch_size=2, seed=1), BOUNDS, device="cpu")
    trainer.init_state()
    return [{k: v.clone() for k, v in trainer.train_one_step(batch, step).items()}
            for step in range(2)]


def test_train_step_spans_nest_and_leave_the_losses_unchanged(tmp_path):
    plain = train_two_steps()
    with timers.ProfilerTrace(str(tmp_path)) as trace:
        traced = train_two_steps()
    for a, b in zip(traced, plain):
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)

    found = spans(trace.path)
    assert set(TRAIN_SPANS) <= set(found)
    assert "trainer/all_reduce" not in found  # no process group: no exchange
    assert len(found["trainer/step"]) == 2
    for name in ("trainer/loss_and_grads", "trainer/optimizer"):
        assert len(found[name]) == 2 and inside(found[name], found["trainer/step"])
    for name in ("encoder/backbone", "encoder/fps"):
        assert inside(found[name], found["trainer/loss_and_grads"])


def test_train_step_all_reduce_is_its_own_span(tmp_path):
    """Under a process group (one gloo rank here) the gradients' exchange is
    ``trainer/all_reduce``: inside ``trainer/step``, after and outside
    ``trainer/loss_and_grads``, and the losses are those without a group."""
    plain = train_two_steps()
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         world_size=1, rank=0)
    try:
        with timers.ProfilerTrace(str(tmp_path / "trace")) as trace:
            grouped = train_two_steps()
    finally:
        torch.distributed.destroy_process_group()
    for a, b in zip(grouped, plain):
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)

    found = spans(trace.path)
    assert len(found["trainer/all_reduce"]) == 2
    assert inside(found["trainer/all_reduce"], found["trainer/step"])
    assert all(grads_end <= a for (_, grads_end), (a, _) in
               zip(found["trainer/loss_and_grads"], found["trainer/all_reduce"]))
