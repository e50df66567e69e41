"""Torch port vs the JAX package: the open-loop app and the visualization
it reaches (``apps/run_open_loop_policy.py``, ``image/pca.py``,
``visualization/visualizer.py``, ``utils/system.py``).

Both apps run on one small dataset (two ``write_arm_demo`` demos) with one
JAX-written checkpoint: a width-24, 5-timestep mesh model initialised by the
JAX trainer, with its ``training_args.json`` beside it, so both apps build
the model from the frozen args. The frozen args sample vertices with the
deterministic ``lowest`` method: the JAX app draws one batch before its
loop (for the model template), and with a random method the draws its
prefetch thread makes then depend on timing. The port predicts each
sample ``i`` with the JAX app's noise for ``PRNGKey(i)``
(``jax_sampler_noise``, swapped in for the port's ``sampler_noise``).

Tolerances: the mean metrics 1e-4 (fp32 summation order through the
sampler, as ``tests/test_torch_model_parity.py``); the PCA, colour maps,
voxel meshes and the feature cloud are host numpy and equal exactly; the
attention and prediction clouds are held by their vertex counts.
"""
import os

import numpy as np
import pytest

import jax

from nvblox_mindmap_tpu.apps import run_open_loop_policy as japp
from nvblox_mindmap_tpu.image import pca as jpca
from nvblox_mindmap_tpu.mapping.constants import get_workspace_bounds
from nvblox_mindmap_tpu.training.checkpoint import save_checkpoint_file, save_training_args
from nvblox_mindmap_tpu.training.trainer import Trainer, TrainerConfig, make_train_batch_template
from nvblox_mindmap_tpu.utils import config as jconfig
from nvblox_mindmap_tpu.visualization import visualizer as jvis
from nvblox_mindmap_torch.apps import run_open_loop_policy as tapp
from nvblox_mindmap_torch.image import pca as tpca
from nvblox_mindmap_torch.utils import system
from nvblox_mindmap_torch.visualization import visualizer as tvis
from tests.test_data_pipeline import write_arm_demo
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    jax_sampler_noise,
    one_torch_thread,
)

METRIC_ATOL = 1e-4
FROZEN = ["--task", "cube_stacking", "--data_type", "mesh", "--feature_type", "rgb",
          "--embedding_dim", "24", "--diffusion_timesteps", "5", "--fps_subsampling_factor", "4",
          "--num_vertices_to_sample", "64", "--vertex_sampling_method", "lowest",
          "--only_sample_keyposes", "1"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("open_loop")
    write_arm_demo(str(root / "ds" / "demo_00000"), seed=0)
    write_arm_demo(str(root / "ds" / "demo_00001"), seed=1)
    args = jconfig.parse_args(jconfig.TrainingAppArgs, FROZEN + ["--dataset", str(root / "ds")])
    cfg = jconfig.model_config_from_args(args)
    trainer = Trainer(cfg, TrainerConfig(save_checkpoint=False),
                      np.asarray(get_workspace_bounds("cube_stacking")))
    params, _ = trainer.init_state(make_train_batch_template(cfg, 1, 64, 8))
    ckpt_dir = root / "ckpt"
    os.makedirs(ckpt_dir)
    save_checkpoint_file(str(ckpt_dir / "last.ckpt"), params, None, 0, 1.0)
    save_training_args(str(ckpt_dir), jconfig.args_to_dict(args))
    argv = ["--dataset", str(root / "ds"), "--task", "cube_stacking", "--demos_open_loop", "0",
            "--checkpoint", str(ckpt_dir / "last.ckpt")]
    jax_ply = str(root / "jax_ply")
    ref = japp.main(argv + ["--ply_output_dir", jax_ply])
    return root, argv, ref, jax_ply


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tapp, "sampler_noise", lambda seed, steps, shape, device:
                        jax_sampler_noise(jax.random.PRNGKey(seed), steps, shape))


def assert_means_close(out, ref):
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(out[k], float), np.asarray(ref[k], float),
                                   atol=METRIC_ATOL, rtol=0, err_msg=k)


def test_open_loop_app_matches_jax(setup, jax_noise):
    _, argv, ref, _ = setup
    out = tapp.main(argv + ["--device", "cpu"])
    assert "distance_m" in out and np.isfinite(out["distance_m"])
    assert_means_close(out, ref)


def _ply_vertex_count(path):
    with open(path) as f:
        header = []
        for line in f:
            header.append(line.strip())
            if line.strip() == "end_header":
                break
        body = sum(1 for line in f if line.strip())
    count = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
    assert count == body, path
    return count


def test_open_loop_ply_export_matches_jax(setup, jax_noise, tmp_path, caplog):
    """``--ply_output_dir`` samples with eager attention (and says so) and
    writes the three clouds per sample, as the JAX app does."""
    _, argv, ref, jax_ply = setup
    ply = str(tmp_path / "ply")
    with caplog.at_level("INFO"):
        out = tapp.main(argv + ["--device", "cpu", "--ply_output_dir", ply])
    assert "sampling with eager attention" in caplog.text
    assert_means_close(out, ref)
    names = sorted(os.listdir(jax_ply))
    assert sorted(os.listdir(ply)) == names
    assert {n.split("_", 2)[-1] for n in names} == {
        "features.ply", "attention.ply", "prediction.ply"}
    for name in names:
        assert _ply_vertex_count(os.path.join(ply, name)) == _ply_vertex_count(
            os.path.join(jax_ply, name)), name
        if name.endswith("features.ply"):
            with open(os.path.join(ply, name)) as f, open(os.path.join(jax_ply, name)) as g:
                assert f.read() == g.read(), name


def test_pca_and_colors_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(200, 16)).astype(np.float32)
    feats[:20] = 0  # never-integrated rows stay out of the fit
    for a, b in zip(tpca.fit_pca(feats), jpca.fit_pca(feats)):
        np.testing.assert_array_equal(a, b)
    proj = tpca.fit_pca(feats)
    image = rng.normal(size=(4, 5, 16))
    np.testing.assert_array_equal(tpca.apply_pca(image, proj), jpca.apply_pca(image, proj))
    rgb, fitted = tpca.apply_pca_return_projection(feats)
    rgb_ref, fitted_ref = jpca.apply_pca_return_projection(feats)
    for a, b in zip((rgb, *fitted), (rgb_ref, *fitted_ref)):
        np.testing.assert_array_equal(a, b)
    # Fewer feature channels than components: zero-padded basis.
    narrow = rng.normal(size=(30, 2))
    for a, b in zip(tpca.fit_pca(narrow), jpca.fit_pca(narrow)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tvis.get_pink_green_color_map(), jvis.get_pink_green_color_map())
    values = rng.uniform(size=50)
    np.testing.assert_array_equal(tvis.values_to_pink_green(values),
                                  jvis.values_to_pink_green(values))
    np.testing.assert_array_equal(tvis.attention_to_colors(values, 0.2),
                                  jvis.attention_to_colors(values, 0.2))
    centers = rng.uniform(size=(7, 3))
    assert tvis.get_voxel_mesh(centers, 0.02)[2] is None
    colors = rng.uniform(size=(7, 3))
    for a, b in zip(tvis.get_voxel_mesh(centers, 0.02, colors),
                    jvis.get_voxel_mesh(centers, 0.02, colors)):
        np.testing.assert_array_equal(a, b)
    loader = [{"vertex_features": feats[i:i + 50][None]} for i in range(0, 200, 50)]
    for a, b in zip(tvis.compute_pca_basis_from_dataset(loader, 3),
                    jvis.compute_pca_basis_from_dataset(loader, 3)):
        np.testing.assert_array_equal(a, b)
    points = rng.uniform(size=(9, 3))
    for pkg in ("port", "jax"):
        vis = tvis if pkg == "port" else jvis
        vis.save_pointcloud_ply(str(tmp_path / f"{pkg}.ply"), points, colors[:1].repeat(9, 0))
        vis.save_feature_pointcloud_ply(str(tmp_path / f"{pkg}_f.ply"), points, feats[:9])
    for name in ("{}.ply", "{}_f.ply"):
        assert (tmp_path / name.format("port")).read_text() == (
            tmp_path / name.format("jax")).read_text()


def test_system_helpers(tmp_path):
    assert system.get_process_memory_mb() > 0
    (tmp_path / "a").write_bytes(b"x" * 2_000_000)
    assert system.get_shmem_usage_mb(str(tmp_path)) == pytest.approx(2.0)
    assert system.get_shmem_usage_mb(str(tmp_path / "missing")) == 0.0
    assert not hasattr(system, "enable_compilation_cache")
