"""Torch port vs the JAX package: rgbd / rgbd_and_mesh keypose prediction.

Small models with the RGB extractor (the ViT is held in
``tests/test_torch_image_path.py``, whose helpers this file uses) in the
four sampler configs of ``tests/test_torch_model_parity.py`` (the trailing
one in relative mode, so the point clouds move with the gripper), with
out-of-bounds points and an invalid image region; the shared feature
encoder, ``use_fps=False`` and ``encode_openness=False`` once each; and the
trained ``spatial_memory/rgbd_last.ckpt``. Weights load strictly through
the bridge; the sampler noise is the JAX sampler's own.

Tolerance: atol 1e-4 (``TRAJ_ATOL``) on the unnormalized trajectory, as for
the mesh path (fp32 summation order through up to 100 chained steps).
"""
import numpy as np
import pytest

from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
from tests.test_torch_fixture_parity import load_params
from tests.test_torch_image_path import SMALL, image_configs, init_jax, make_image_batch
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    BOUNDS,
    SAMPLERS,
    TRAJ_ATOL,
    assert_outputs_close,
    one_torch_thread,
    run_both,
)


TRAJ_CASES = {
    # (data_type, extra config fields)
    "rgbd": ("rgbd", {}),
    "rgbd_and_mesh": ("rgbd_and_mesh", {}),
    "rgbd_and_mesh_shared": ("rgbd_and_mesh", dict(use_shared_feature_encoder=True)),
    "rgbd_and_mesh_no_fps": ("rgbd_and_mesh", dict(use_fps=False)),
    "rgbd_and_mesh_no_openness": ("rgbd_and_mesh", dict(encode_openness=False)),
}
# Every sampler config for the two data types; one for each switch.
TRAJ_PARAMS = (
    [(case, sampler) for case in ("rgbd", "rgbd_and_mesh") for sampler in sorted(SAMPLERS)]
    + [(case, "ddim10_leading") for case in ("rgbd_and_mesh_shared",
                                             "rgbd_and_mesh_no_fps",
                                             "rgbd_and_mesh_no_openness")]
)


@pytest.mark.parametrize("case,sampler", TRAJ_PARAMS)
def test_sample_trajectory_matches_jax(case, sampler):
    data_type, fields = TRAJ_CASES[case]
    fields = dict(SMALL, relative=sampler.endswith("relative"), **fields)
    jcfg, tcfg = image_configs(data_type, **fields)
    batch = make_image_batch(np.random.default_rng(10), 2, 2, 16, BOUNDS,
                             n_vertices=32 if data_type == "rgbd_and_mesh" else 0)
    _, _, params = init_jax(jcfg, batch, BOUNDS)
    if not fields.get("encode_openness", True):
        assert "gripper_history_embed" in params["encoder"]
    if fields.get("use_shared_feature_encoder"):
        assert "reconstruction_encoder" not in params["encoder"]
    out, ref = run_both(jcfg, tcfg, params, batch, BOUNDS, seed=12, **SAMPLERS[sampler])
    assert out[0].shape == (2, 1, 1, 8)
    assert_outputs_close(out, ref, TRAJ_ATOL)


def test_rgbd_fixture_trajectory_matches_jax():
    """``spatial_memory/rgbd_last.ckpt`` (width 72, RGB features on a 16x16
    grid, 64x64 images, FPS factor 4) loads strictly and samples DDPM-100
    as the JAX package does."""
    params = load_params("spatial_memory/rgbd_last.ckpt")
    jcfg, tcfg = image_configs("rgbd", feature_image_size=(16, 16), embedding_dim=72,
                               num_attn_heads=8, diffusion_timesteps=100,
                               fps_subsampling_factor=4)
    bounds = get_workspace_bounds("cube_stacking")
    batch = make_image_batch(np.random.default_rng(13), 2, 2, 64, bounds)
    out, ref = run_both(jcfg, tcfg, params, batch, bounds, seed=5,
                        num_inference_steps=100, scheduler_kind="ddpm", stochastic=True)
    assert out[0].shape == (2, 1, 1, 8)
    assert_outputs_close(out, ref, TRAJ_ATOL)
