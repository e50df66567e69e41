"""Torch port vs the JAX package: the training app's CLI and flow.

Held against the JAX package: ``parse_args`` on the same argv (the same
``args_to_dict``), ``model_config_from_args`` on every field both configs
have, and the ``training_args.json`` overlay. The port's own app, with
``--device cpu`` at a tiny width on demos in the reference layout: a few
iterations write ``best.ckpt``, ``last.ckpt`` and ``training_args.json``,
and the port's closed-loop policy predicts from ``best.ckpt`` rebuilt through
the overlay; ``--eval_only`` on the committed cube_stacking fixture; the
packed epoch, the asynchronous checkpoint backend and the world-size check
of a torchrun launch (``tests/test_torch_packed.py`` and
``tests/test_torch_parallel.py`` hold them against the JAX app). The JAX
app itself is not run here (its XLA compile takes minutes).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from nvblox_mindmap_tpu.utils import config as jconfig
from nvblox_mindmap_torch.apps import run_training as app
from nvblox_mindmap_torch.data import item_io
from nvblox_mindmap_torch.scripts import pack_dataset
from nvblox_mindmap_torch.utils import config as tconfig
from nvblox_mindmap_torch.utils.logging_utils import MetricLogger
from tests.test_data_pipeline import write_arm_demo
from tests.test_torch_fixture_parity import DATA

ARGVS = [
    [],
    ["--task", "cube_stacking", "--data_type", "rgbd_and_mesh", "--feature_type",
     "radio_v25_b", "--embedding_dim", "120", "--batch_size", "32", "--batch_size_val", "32",
     "--num_vertices_to_sample", "2048", "--num_workers", "4"],
    ["--task", "drill_in_box", "--data_type", "mesh", "--feature_type", "rgb",
     "--extra_keyposes_around_grasp_events", "5,15", "--keypose_detection_mode",
     "highest_z_of_vertical_motion", "--random_translation_range_m",
     "[-0.2,-0.1,0],[0.2,0.1,0.05]", "--image_size", "256,256", "--use_fps", "0",
     "--vertex_sampling_method", "lowest", "--demos_valset", "none", "--seed", "7",
     "--initial_learning_rate", "3e-4", "--add_external_cam", "true"],
]


@pytest.mark.parametrize("argv", range(len(ARGVS)))
def test_parse_args_matches_jax(argv):
    argv = ARGVS[argv]
    ours = tconfig.parse_args(tconfig.TrainingAppArgs, argv)
    ref = jconfig.parse_args(jconfig.TrainingAppArgs, argv)
    assert tconfig.args_to_dict(ours) == jconfig.args_to_dict(ref)
    assert ours.device == "cuda"
    for package in (tconfig, jconfig):
        with pytest.raises(SystemExit):
            package.parse_args(package.TrainingAppArgs, ["--batch_sise", "3"])
        with pytest.raises(ValueError, match="ego-cam"):
            package.parse_args(package.TrainingAppArgs, ["--add_external_cam", "1"])


@pytest.mark.parametrize("task", ["cube_stacking", "drill_in_box"])
@pytest.mark.parametrize("data_type", ["mesh", "rgbd", "rgbd_and_mesh"])
def test_model_config_from_args_matches_jax(task, data_type):
    argv = ["--task", task, "--data_type", data_type, "--embedding_dim", "96",
            "--num_history", "4", "--encoder_dropout", "0.1", "--pos_loss", "20",
            "--feature_type", "rgb" if data_type == "mesh" else "dino_v2_vits14"]
    ours = tconfig.model_config_from_args(tconfig.parse_args(tconfig.TrainingAppArgs, argv),
                                          vertex_feature_dim=3)
    ref = jconfig.model_config_from_args(jconfig.parse_args(jconfig.TrainingAppArgs, argv))
    shared = ({f.name for f in dataclasses.fields(ours)}
              & {f.name for f in dataclasses.fields(ref)})
    assert len(shared) >= 25
    for name in shared:
        a, b = getattr(ours, name), getattr(ref, name)
        if name == "loss_weights":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert getattr(a, "value", a) == getattr(b, "value", b), name
    # The two fields the port sizes up front: the data type (its default is
    # "mesh", JAX's "rgbd_and_mesh") and the vertex-feature width.
    assert ours.data_type == data_type and ours.vertex_feature_dim == 3
    default = tconfig.model_config_from_args(tconfig.TrainingAppArgs())
    assert (default.data_type, default.vertex_feature_dim) == ("rgbd_and_mesh", 768)


def test_training_args_overlay_matches_jax(tmp_path):
    frozen = jconfig.TrainingAppArgs(embedding_dim=48, data_type="mesh", num_history=2,
                                     task="cube_stacking", batch_size=5)
    with open(tmp_path / "training_args.json", "w") as f:
        json.dump(jconfig.args_to_dict(frozen), f)
    argv = ["--checkpoint", str(tmp_path / "best.ckpt"), "--embedding_dim", "120",
            "--batch_size", "9", "--task", "cube_stacking"]
    ours = tconfig.update_model_args_from_checkpoint(
        tconfig.parse_args(tconfig.TrainingAppArgs, argv))
    ref = jconfig.update_model_args_from_checkpoint(
        jconfig.parse_args(jconfig.TrainingAppArgs, argv))
    assert tconfig.args_to_dict(ours) == jconfig.args_to_dict(ref)
    # Model args come from the file, the rest from the command line.
    assert (ours.embedding_dim, ours.num_history, ours.batch_size) == (48, 2, 9)
    assert ours.data_type == tconfig.DataType.MESH


@pytest.fixture(scope="module")
def rgb_dataset(tmp_path_factory):
    """Three arm demos in the reference layout with 3-d vertex features, as
    a ``--feature_type rgb`` dataset has."""
    root = tmp_path_factory.mktemp("rgb_dataset")
    for i in range(3):
        demo = root / f"demo_0000{i}"
        write_arm_demo(str(demo), n_frames=100, n_vertices=48, seed=i)
        for name in os.listdir(demo):
            if name.endswith(".zst"):
                mesh = item_io.unpickle_zst(str(demo / name))
                item_io.pickle_zst({"vertices": mesh["vertices"],
                                    "features": mesh["features"][:, :3],
                                    "channel_length": 3}, str(demo / name))
    return str(root)


@pytest.fixture
def no_figures(monkeypatch):
    """The trajectory figure (matplotlib) is not under test here."""
    monkeypatch.setattr(MetricLogger, "log_trajectory_figure", lambda self, *a, **k: None)


TINY = ["--task", "cube_stacking", "--data_type", "mesh", "--feature_type", "rgb",
        "--embedding_dim", "24", "--diffusion_timesteps", "5", "--fps_subsampling_factor", "4",
        "--num_vertices_to_sample", "32", "--device", "cpu", "--print_progress_freq", "100"]


def test_app_trains_and_the_policy_predicts_from_best(rgb_dataset, tmp_path, no_figures):
    from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
    from nvblox_mindmap_torch.mapping.constants import MappingConfig, get_workspace_bounds
    from nvblox_mindmap_torch.training.trainer import Trainer

    logs = str(tmp_path / "logs")
    result = app.main(TINY + ["--dataset", rgb_dataset, "--demos_train", "0-1",
                              "--demos_valset", "2", "--batch_size", "8",
                              "--batch_size_val", "8", "--train_iters", "4", "--val_freq", "2",
                              "--num_batches_per_test_eval", "1", "--skip_train_val", "1",
                              "--num_workers", "2", "--base_log_dir", logs])
    ckpt_dir = result["checkpoint_dir"]
    for name in ("best.ckpt", "last.ckpt", "training_args.json"):
        assert os.path.isfile(os.path.join(ckpt_dir, name)), name
    assert np.isfinite(result["best_loss"])
    assert os.path.realpath(os.path.join(logs, "checkpoints", "latest")) == os.path.realpath(
        ckpt_dir)
    assert result["trainer"].model.config.vertex_feature_dim == 3
    assert result["trainer"].optimizer.count == 4

    # A fresh process's path: the frozen args rebuild the model from best.ckpt.
    best = os.path.join(ckpt_dir, "best.ckpt")
    args = tconfig.update_model_args_from_checkpoint(tconfig.parse_args(
        tconfig.TrainingAppArgs, ["--checkpoint", best, "--task", "cube_stacking",
                                  "--embedding_dim", "120", "--device", "cpu"]))
    assert args.embedding_dim == 24 and args.data_type == tconfig.DataType.MESH
    cfg = tconfig.model_config_from_args(args, vertex_feature_dim=3)
    bounds = get_workspace_bounds(args.task)
    trainer = Trainer(cfg, result["trainer"].config, bounds, device="cpu")
    trainer.load_checkpoint(best)
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            torch.load(best, weights_only=True)["state_dict"].values()):
        assert torch.equal(a, b), name
    policy = NvbloxDiffuserActorPolicy(
        trainer.model, app.make_embodiment_for_task(args.task),
        MappingConfig.for_task(args.task, feature_dim=3), bounds, num_vertices_to_sample=32,
        num_inference_steps=5, scheduler_kind="ddim", stochastic_sampling=False,
        device="cpu")
    train_loader, _, _ = app.build_loaders(dataclasses.replace(
        args, dataset=rgb_dataset, demos_train="2", batch_size=1), policy.embodiment)
    batch = next(iter(train_loader))
    traj, head_yaw = policy.predict(batch)
    assert traj.shape == (1, 1, 1, 8) and np.isfinite(traj).all() and head_yaw is None


def test_eval_only_on_the_committed_fixture(rgb_dataset, tmp_path, no_figures):
    """The cube_stacking fixture (width 72, 3-d vertex features) over the
    keyposes of the validation demo (every batch, the tail one too): a
    finite loss, no checkpoint written."""
    fixture = os.path.join(DATA, "task_success/cube_stacking/last.ckpt")
    result = app.main(["--task", "cube_stacking", "--data_type", "mesh", "--feature_type",
                       "rgb", "--embedding_dim", "72", "--fps_subsampling_factor", "4",
                       "--num_vertices_to_sample", "64", "--device", "cpu", "--dataset",
                       rgb_dataset, "--demos_train", "2", "--only_sample_keyposes", "1",
                       "--batch_size_val", "8", "--eval_only", "1", "--checkpoint", fixture,
                       "--base_log_dir", str(tmp_path)])
    assert result["start_iter"] == 35999
    assert np.isfinite(result["val_loss"]) and result["val_loss"] < 1e3
    assert not os.path.exists(os.path.join(result["checkpoint_dir"], "last.ckpt"))


def test_options_of_later_slices_raise(rgb_dataset, tmp_path, monkeypatch, no_figures):
    """The JAX app's options beyond one streaming GPU, which raised here
    until their slice was ported, now run: ``--packed_dataset`` trains from
    a packed epoch, ``--checkpoint_backend orbax`` writes best/ and last/
    directories and ``--checkpoint`` resumes from last/, and a WORLD_SIZE
    that does not split ``--batch_size`` raises before any process group is
    joined. What still raises: wandb without its package, an rgbd model
    without pretrained weights, and the default device without a card."""
    base = TINY + ["--dataset", rgb_dataset, "--base_log_dir", str(tmp_path)]
    run = base + ["--demos_train", "0-1", "--demos_valset", "2", "--batch_size", "8",
                  "--batch_size_val", "8", "--train_iters", "2", "--val_freq", "2",
                  "--num_batches_per_test_eval", "1", "--skip_train_val", "1"]
    packed = str(tmp_path / "packed")
    assert pack_dataset.main(run + ["--packed_out", packed,
                                    "--packed_num_batches", "2"])["num_batches"] == 2
    run += ["--packed_dataset", packed, "--checkpoint_backend", "orbax"]
    result = app.main(run)
    ckpt_dir = result["checkpoint_dir"]
    assert {"best", "last", "training_args.json"} <= set(os.listdir(ckpt_dir))
    assert os.path.isdir(os.path.join(ckpt_dir, "last"))
    assert result["trainer"].optimizer.count == 2
    assert os.path.realpath(os.path.join(tmp_path, "checkpoints", "latest")) == \
        os.path.realpath(ckpt_dir)
    resumed = app.main(run + ["--train_iters", "3", "--checkpoint",
                              os.path.join(ckpt_dir, "last")])
    assert resumed["start_iter"] == 1 and resumed["trainer"].optimizer.count == 2 + 2
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not split into the 3 ranks"):
        app.main(base + ["--batch_size", "8"])
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="wandb_mode disabled"):
        app.main(base + ["--wandb_mode", "offline"])
    with pytest.raises(ValueError, match="pretrained weights"):
        app.main(base + ["--data_type", "rgbd", "--feature_type", "radio_v25_b"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.main([a for a in base if a not in ("--device", "cpu")])
