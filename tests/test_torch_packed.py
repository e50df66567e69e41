"""Torch port vs the JAX package: packed epochs and training fed from them.

Held against the JAX package on the CPU:
- ``pack_dataset`` and ``materialize_packed_epoch`` write the JAX package's
  files byte for byte (from the same loader batches, and end to end from
  the same demos), and each package reads the other's epoch;
- ``PackedDeviceLoader`` gives the JAX loader's batch orders over three
  epochs and after ``set_epoch``;
- the training app's packed mode refuses the JAX app's four flags with its
  message, and its train losses over three steps from one JAX checkpoint,
  with the JAX app's noise and timesteps injected, match the JAX app's
  (rtol 1e-5: fp32 summation orders, as a single train step is held in
  ``tests/test_torch_training.py``).
The port's own rules: the uint8 cases of ``tests/test_packed.py`` (round
trip, the batch cap and shape guard, float RGB kept as float, a mixed grid
raising), staging (uint8 on the device, views and no copies, a rank's
rows), and a trainer step from a staged batch equal, bit for bit, to the
step from the streaming loader's batch.
"""
import os

import numpy as np
import pytest
import torch

import jax

from nvblox_mindmap_tpu.apps import run_training as japp
from nvblox_mindmap_tpu.data import packed as jpacked
from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.scripts import pack_dataset as jpack
from nvblox_mindmap_tpu.training import checkpoint as jckpt
from nvblox_mindmap_tpu.training import trainer as jtrainer
from nvblox_mindmap_tpu.utils import config as jconfig
from nvblox_mindmap_torch.apps import run_training as tapp
from nvblox_mindmap_torch.data import packed as tpacked
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
from nvblox_mindmap_torch.parallel.mesh import DataMesh
from nvblox_mindmap_torch.scripts import pack_dataset as tpack
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils import config as tconfig
from nvblox_mindmap_torch.utils.logging_utils import MetricLogger
from tests.test_data_pipeline import write_arm_demo
from tests.test_packed import _synthetic_batches
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_training import jax_step_noise

CPU = DataMesh(torch.device("cpu"))
FLAGS = ["--task", "cube_stacking", "--feature_type", "rgb", "--demos_train", "0-1",
         "--batch_size", "4", "--num_vertices_to_sample", "32", "--fps_subsampling_factor",
         "4", "--embedding_dim", "24", "--diffusion_timesteps", "5"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("packed_ds")
    write_arm_demo(str(root / "demo_00000"), seed=0)
    write_arm_demo(str(root / "demo_00001"), seed=1)
    return str(root)


@pytest.fixture(scope="module")
def packed(dataset, tmp_path_factory):
    """A mesh epoch packed by the port: (its directory, pack argv)."""
    out = str(tmp_path_factory.mktemp("packed") / "epoch")
    argv = FLAGS + ["--dataset", dataset, "--data_type", "mesh", "--packed_out", out,
                    "--packed_num_batches", "4"]
    tpack.main(argv)
    return out, argv


@pytest.fixture
def no_figures(monkeypatch):
    monkeypatch.setattr(MetricLogger, "log_trajectory_figure", lambda self, *a, **k: None)


def files_of(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


# ------------------------------------------------------------- host half


def test_materialize_writes_the_jax_bytes_from_the_same_batches(tmp_path):
    batches = _synthetic_batches(n=4)
    ours = tpacked.materialize_packed_epoch(batches, str(tmp_path / "t"))
    ref = jpacked.materialize_packed_epoch(batches, str(tmp_path / "j"))
    assert ours == ref
    assert ours["keys"]["rgbs"]["rgb_uint8"] is True
    theirs = files_of(tmp_path / "j")
    assert sorted(theirs) == sorted(os.listdir(tmp_path / "t")) and len(theirs) == 7
    for name, data in files_of(tmp_path / "t").items():
        assert data == theirs[name], name


@pytest.mark.parametrize("data_type", ["mesh", "rgbd_and_mesh"])
def test_pack_dataset_writes_the_jax_bytes(dataset, tmp_path, data_type):
    """Both packages' pack_dataset on the same demos, over more batches than
    an epoch holds (the loader cycles)."""
    argv = FLAGS + ["--dataset", dataset, "--data_type", data_type,
                    "--packed_num_batches", "5"]
    ours = tpack.main(argv + ["--packed_out", str(tmp_path / "t")])
    ref = jpack.main(argv + ["--packed_out", str(tmp_path / "j")])
    assert ours == ref and ours["num_batches"] == 5
    assert ("rgbs" in ours["keys"]) == (data_type == "rgbd_and_mesh")
    if data_type == "rgbd_and_mesh":
        assert ours["keys"]["rgbs"]["dtype"] == "uint8"
    assert files_of(tmp_path / "t") == files_of(tmp_path / "j")


def test_each_package_reads_the_others_epoch(tmp_path):
    batches = _synthetic_batches(n=3)
    tpacked.materialize_packed_epoch(batches, str(tmp_path / "t"))
    jpacked.materialize_packed_epoch(batches, str(tmp_path / "j"))
    for reader, path in ((jpacked.PackedEpoch, "t"), (tpacked.PackedEpoch, "j")):
        epoch = reader(str(tmp_path / path))
        assert len(epoch) == 3
        for i, orig in enumerate(batches):
            got = epoch.batch(i)
            for k, v in orig.items():
                if v is None:
                    assert got[k] is None, k
                else:
                    np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_materialize_roundtrip_exact(tmp_path):
    batches = _synthetic_batches()
    meta = tpacked.materialize_packed_epoch(batches, str(tmp_path))
    assert meta["num_batches"] == 5
    assert meta["keys"]["rgbs"]["rgb_uint8"] is True
    assert meta["keys"]["rgbs"]["dtype"] == "uint8"
    assert meta["keys"]["vertex_features"]["dtype"] == "float16"
    assert sorted(meta["none_keys"]) == ["gt_head_yaw", "instruction"]
    epoch = tpacked.PackedEpoch(str(tmp_path))
    assert len(epoch) == 5 and isinstance(epoch.arrays["pcds"], np.memmap)
    for i, orig in enumerate(batches):
        got = epoch.batch(i)
        assert got["instruction"] is None and got["gt_head_yaw"] is None
        for k, v in orig.items():
            if v is not None:
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_materialize_num_batches_cap_and_shape_guard(tmp_path):
    meta = tpacked.materialize_packed_epoch(_synthetic_batches(n=5), str(tmp_path / "a"),
                                            num_batches=3)
    assert meta["num_batches"] == 3
    assert tpacked.PackedEpoch(str(tmp_path / "a")).arrays["vertices"].shape[0] == 3
    bad = _synthetic_batches(n=2)
    bad[1]["vertices"] = bad[1]["vertices"][:, :7]
    with pytest.raises(AssertionError, match="shape"):
        tpacked.materialize_packed_epoch(bad, str(tmp_path / "b"))


def test_non_uint8_rgb_keeps_float(tmp_path):
    batches = _synthetic_batches(n=2)
    for b in batches:
        b["rgbs"] = b["rgbs"] * 0.7 + 0.001
    meta = tpacked.materialize_packed_epoch(batches, str(tmp_path))
    assert meta["keys"]["rgbs"]["rgb_uint8"] is False
    got = tpacked.PackedEpoch(str(tmp_path)).batch(0)
    np.testing.assert_array_equal(got["rgbs"], batches[0]["rgbs"])


def test_mixed_uint8_exact_then_inexact_rgb_raises(tmp_path):
    batches = _synthetic_batches(n=3)
    batches[2]["rgbs"] = batches[2]["rgbs"] * 0.7 + 0.001
    with pytest.raises(ValueError, match="uint8/255"):
        tpacked.materialize_packed_epoch(batches, str(tmp_path))


# ----------------------------------------------------------- device half


def test_packed_loader_orders_match_jax(tmp_path):
    """Three epochs of shuffled orders, and a fresh loader pinned to epoch 2,
    as the JAX loader gives them (numpy's generator in both)."""
    tpacked.materialize_packed_epoch(_synthetic_batches(n=5), str(tmp_path))
    ours = tpacked.PackedDeviceLoader(str(tmp_path), mesh=CPU, seed=7)
    ref = jpacked.PackedDeviceLoader(str(tmp_path), seed=7)

    def order(loader):
        return [np.asarray(b["vertices"]).tobytes() for b in loader]

    epochs = [order(ours) for _ in range(3)]
    assert epochs == [order(ref) for _ in range(3)]
    assert epochs[0] != epochs[2]  # epochs reshuffle
    for loader in (tpacked.PackedDeviceLoader(str(tmp_path), mesh=CPU, seed=7),
                   jpacked.PackedDeviceLoader(str(tmp_path), seed=7)):
        loader.set_epoch(2)
        assert order(loader) == epochs[2]
    assert tpacked.PackedDeviceLoader.sampler is None


def test_stage_gives_views_and_the_ranks_rows(tmp_path):
    batches = _synthetic_batches(n=3)
    tpacked.materialize_packed_epoch(batches, str(tmp_path))
    epoch = tpacked.PackedEpoch(str(tmp_path))
    staged = tpacked.stage_to_device(epoch, mesh=CPU)
    assert staged["rgbs"].dtype == torch.uint8 and staged["instruction"] is None
    for i in range(4):  # step 3 wraps to batch 0
        db = tpacked.device_batch(staged, i)
        assert db["pcds"].untyped_storage().data_ptr() == \
            staged["pcds"].untyped_storage().data_ptr()
        np.testing.assert_array_equal(db["pcds"].numpy(), batches[i % 3]["pcds"])
        np.testing.assert_array_equal(db["rgbs"].numpy().astype(np.float32) / 255.0,
                                      batches[i % 3]["rgbs"])
    rank1 = tpacked.stage_to_device(epoch, indices=[2, 0],
                                    mesh=DataMesh(torch.device("cpu"), 1, 2))
    np.testing.assert_array_equal(rank1["vertices"].numpy(),
                                  np.stack([batches[2]["vertices"][2:],
                                            batches[0]["vertices"][2:]]))
    with pytest.raises(ValueError, match="3 ranks"):
        tpacked.stage_to_device(epoch, mesh=DataMesh(torch.device("cpu"), 0, 3))


def test_a_step_from_a_staged_batch_equals_the_host_fed_step(packed):
    """The same first batch, from the streaming loader (host arrays) and
    from the staged epoch (views on the device): the same loss, bit for bit,
    and the same gradients."""
    out, argv = packed
    args = tconfig.parse_args(tpack.PackDatasetArgs, argv)
    loader, _, _ = tapp.build_loaders(args, make_embodiment_for_task(args.task), skip_val=True)
    host = next(iter(loader))
    staged = next(iter(tpacked.PackedDeviceLoader(out, mesh=CPU, shuffle=False)))
    cfg = tconfig.model_config_from_args(args, vertex_feature_dim=8)
    bounds = tapp.get_workspace_bounds(args.task)
    losses, grads = [], []
    for batch in (host, staged):
        trainer = Trainer(cfg, TrainerConfig(batch_size=4), bounds, device="cpu")
        trainer.init_state()
        losses.append(float(trainer.compute_loss_and_grads(batch, 0)["total"]))
        grads.append([p.grad for p in trainer.optimizer.params if p.grad is not None])
    assert losses[0] == losses[1]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [["--apply_random_transforms", "1"],
                                  ["--apply_geometry_noise", "1"],
                                  ["--balance_demo_groups", "0-0,1-1"],
                                  ["--sampling_weighting_type", "gripper_state_change"]])
def test_packed_app_refuses_the_jax_apps_flags(dataset, packed, tmp_path, flag):
    out, _ = packed
    argv = FLAGS + ["--dataset", dataset, "--data_type", "mesh", "--packed_dataset", out,
                    "--base_log_dir", str(tmp_path)] + flag
    with pytest.raises(ValueError, match="no effect") as ours:
        tapp.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="no effect") as ref:
        japp.main(argv)
    assert str(ours.value) == str(ref.value)


def test_packed_app_losses_match_the_jax_app(dataset, packed, tmp_path, monkeypatch,
                                             no_figures):
    """Both apps train 3 steps from one packed epoch, starting from the same
    JAX checkpoint (the JAX trainer's init); the port's steps get the JAX
    app's noise and timesteps."""
    out, _ = packed
    argv = FLAGS + ["--dataset", dataset, "--data_type", "mesh", "--batch_size_val", "4",
                    "--train_iters", "3", "--val_freq", "4", "--seed", "0",
                    "--packed_dataset", out]  # no evaluation: it is not compared
    jcfg = jconfig.model_config_from_args(jconfig.parse_args(jconfig.TrainingAppArgs, argv))
    bounds = japp.get_workspace_bounds("cube_stacking")
    template = tpacked.PackedEpoch(out).batch(0)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(batch_size=4), bounds)
    params, opt_state = jt.init_state(template)
    init = str(tmp_path / "init" / "init.ckpt")
    os.makedirs(os.path.dirname(init))
    jckpt.save_checkpoint_file(init, jax.device_get(params), jax.device_get(opt_state), 0,
                               None)

    recorded = {"jax": [], "torch": []}
    jax_step = jtrainer.Trainer.train_one_step

    def jax_recording(self, params, opt_state, batch, step, on_device=False):
        params, opt_state, losses = jax_step(self, params, opt_state, batch, step, on_device)
        recorded["jax"].append(float(np.asarray(losses["total"])))
        return params, opt_state, losses

    torch_step = Trainer.train_one_step

    def torch_with_jax_noise(self, batch, step, noise=None, timesteps=None):
        host = {k: None if v is None else jax.numpy.asarray(v.numpy())
                for k, v in batch.items()}
        jprep = jda.prepare_inputs(host, jax.numpy.asarray(bounds), jcfg)
        noise, timesteps = jax_step_noise(jcfg, jprep,
                                          jax.random.fold_in(jax.random.PRNGKey(0), step))
        losses = torch_step(self, batch, step, noise, timesteps)
        recorded["torch"].append(float(losses["total"]))
        return losses

    monkeypatch.setattr(jtrainer.Trainer, "train_one_step", jax_recording)
    monkeypatch.setattr(Trainer, "train_one_step", torch_with_jax_noise)
    common = argv + ["--checkpoint", init]
    japp.main(common + ["--base_log_dir", str(tmp_path / "jax")])
    result = tapp.main(common + ["--base_log_dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert result["start_iter"] == 0 and result["trainer"].optimizer.count == 3
    assert len(recorded["jax"]) == len(recorded["torch"]) == 3
    np.testing.assert_allclose(recorded["torch"], recorded["jax"], rtol=1e-5, atol=0)
