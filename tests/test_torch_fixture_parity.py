"""Torch port vs the JAX package on the five committed mesh checkpoints.

Each fixture's flax parameter tree (``params`` of the checkpoint payload,
restored with flax msgpack) loads into the port strictly through
``models/weights.py``. Both models then sample with the fixture's serving
config on the same numpy inputs (128 vertices of RGB features, positions
inside the task's workspace) and the JAX sampler's own noise. Width 72,
8 heads, 100 train timesteps, FPS factor 4 (the config of
``scripts/task_success_experiment.py``); drill and stick are humanoid:
2 grippers and a head-yaw predictor.

Tolerance: atol 1e-4 on the unnormalized trajectory and head yaw, as in
``tests/test_torch_model_parity.py`` (fp32 summation order through up to
100 chained steps; the port's acceptance bound is 1e-3).
"""
import os
import pickle

import numpy as np
import pytest

from flax import serialization

from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models.converter import convert_diffusion_scheduler
from nvblox_mindmap_torch.models.weights import load_flax_params
from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    TRAJ_ATOL,
    assert_outputs_close,
    configs,
    make_batch,
    one_torch_thread,
    run_both,
)

DATA = os.path.join(os.path.dirname(__file__), "test_data")
DDIM10 = convert_diffusion_scheduler(10)
# (checkpoint, task, humanoid, serving config). The per-task serving configs
# are those of tests/test_task_success.py (mug DDIM-10, drill DDIM-10
# trailing, stick stochastic DDPM-20); cube serves DDIM-10 as mug does, and
# the spatial-memory checkpoint runs the training sampler, DDPM-100.
FIXTURES = {
    "cube_stacking": ("task_success/cube_stacking/last.ckpt", "cube_stacking", False, DDIM10),
    "mug_in_drawer": ("task_success/mug_in_drawer/last.ckpt", "mug_in_drawer", False, DDIM10),
    "drill_in_box": ("task_success/drill_in_box/last.ckpt", "drill_in_box", True,
                     dict(DDIM10, timestep_spacing="trailing")),
    "stick_in_bin": ("task_success/stick_in_bin/last.ckpt", "stick_in_bin", True,
                     dict(num_inference_steps=20, scheduler_kind="ddpm", stochastic=True)),
    "spatial_memory_mesh": ("spatial_memory/mesh_last.ckpt", "cube_stacking", False,
                            dict(num_inference_steps=100, scheduler_kind="ddpm",
                                 stochastic=True)),
}
N_VERTICES = 128


@pytest.fixture(autouse=True)
def eager_default_impl():
    """Both samplers run their default attention, eager, whatever an app or
    test run earlier in the same process left as the port's default (the
    apps switch it to flash)."""
    set_default_attention_impl("eager")
    yield
    set_default_attention_impl("eager")


def load_params(path):
    with open(os.path.join(DATA, path), "rb") as f:
        payload = pickle.load(f)
    return serialization.msgpack_restore(payload["params"])


def fixture_configs(humanoid):
    return configs(3, embedding_dim=72, num_attn_heads=8, diffusion_timesteps=100,
                   fps_subsampling_factor=4, ngrippers=2 if humanoid else 1,
                   predict_head_yaw=humanoid)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_trajectory_matches_jax(name):
    path, task, humanoid, serving = FIXTURES[name]
    params = load_params(path)
    jcfg, tcfg = fixture_configs(humanoid)
    bounds = get_workspace_bounds(task)
    rng = np.random.default_rng(sorted(FIXTURES).index(name))
    batch = make_batch(rng, 2, tcfg.ngrippers, N_VERTICES, 3, bounds, n_invalid=16)
    out, ref = run_both(jcfg, tcfg, params, batch, bounds, seed=5, **serving)
    assert out[0].shape == (2, 1, tcfg.ngrippers, 8)
    assert (out[1] is not None) == humanoid
    assert_outputs_close(out, ref, TRAJ_ATOL)


def test_fixtures_load_strictly_and_rgbd_does_not():
    """Every mesh fixture fills every parameter of the port's model exactly;
    the RGB-D checkpoint carries the image encoder, which the mesh model
    lacks, so the strict bridge refuses it."""
    for name, (path, _, humanoid, _) in FIXTURES.items():
        model = tda.DiffuserActor(fixture_configs(humanoid)[1], device="cpu")
        load_flax_params(model, load_params(path))
        assert model.encoder.reconstruction_encoder.weight.shape == (72, 3), name
    model = tda.DiffuserActor(fixture_configs(False)[1], device="cpu")
    with pytest.raises(KeyError, match="image_feature_encoder"):
        load_flax_params(model, load_params("spatial_memory/rgbd_last.ckpt"))


def test_workspace_bounds_match_jax_table():
    from nvblox_mindmap_tpu.mapping.constants import get_workspace_bounds as jax_bounds
    from nvblox_mindmap_tpu.embodiments.registry import Tasks

    for task in Tasks:
        np.testing.assert_array_equal(get_workspace_bounds(task.value), jax_bounds(task))
