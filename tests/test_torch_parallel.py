"""Torch port vs the JAX package: multi-process training and batched serving.

- The multihost helpers in one process give the JAX package's
  single-process answers.
- Two ranks under ``python -m torch.distributed.run`` (gloo on the CPU, one
  launch for the module): the metric gather, mean and barrier give
  ``tests/test_multihost.py``'s expectations; 2 ranks x 4 rows train like
  1 rank x 8 rows (losses and parameters after 2 steps within 1e-6, but
  for the attention k-projection biases: their gradient is zero up to
  rounding, so Adam steps them by rounding noise, and they are held to one
  step of lr) and like JAX, at ``tests/test_torch_training.py``'s
  tolerances: the losses of the JAX single-process ``Trainer``'s 2 steps
  within rtol 1e-5, and one step's averaged gradients against
  ``jax.value_and_grad`` within atol 1e-5 / rtol 1e-4; each rank evaluates
  its rows of an eval batch, a batch that does not divide is trimmed (one
  smaller than the ranks skipped), each kept batch's loss is the one
  process's on its kept rows (rtol 1e-6, DDIM and DDPM), and with the eval
  step stubbed the loop's warnings, weighted loss, metrics and figure are
  those of the JAX trainer's ``evaluate_nsteps`` over a 2-device mesh; each rank
  stages its rows of a packed epoch; the
  asynchronous checkpoint backend saves collectively and restores bit for
  bit; the training app itself, packed and with ``--checkpoint_backend
  orbax``, gives the one-process app's losses and final parameters
  (within 1e-6), and a run resumes from its ``last/``.
- Serving: over two CPU devices equal to one call (1e-6), against JAX's
  ``make_sharded_infer_fn`` on its 8 virtual devices with the JAX draws
  injected (1e-5), an indivisible batch raising, DDIM serving, and the
  parameters copied once per distinct object.
"""
import dataclasses
import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
from nvblox_mindmap_tpu.parallel.serving import make_sharded_infer_fn as jax_infer_fn
from nvblox_mindmap_tpu.training import trainer as jtrainer
from nvblox_mindmap_torch.apps import run_training as tapp
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models.converter import convert_diffusion_scheduler
from nvblox_mindmap_torch.models.weights import flax_to_state_dict, load_flax_params
from nvblox_mindmap_torch.parallel import multihost as mh
from nvblox_mindmap_torch.parallel.serving import make_sharded_infer_fn
from nvblox_mindmap_torch.scripts import pack_dataset as tpack
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils.logging_utils import MetricLogger
from tests.test_data_pipeline import write_arm_demo
from tests.test_serving import make_batch as serving_batch
from tests.test_serving import small_model
from tests.test_torch_image_path import init_jax
from tests.test_torch_model_parity import BOUNDS, configs, jax_sampler_noise
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_training import SMALL, jax_step_noise, jax_train_step, mesh_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = dict(batch_size=8, train_iters=8, initial_learning_rate=1e-3,
              eval_num_inference_steps=3)
APP = ["--task", "cube_stacking", "--data_type", "mesh", "--feature_type", "rgb",
       "--demos_train", "0-1", "--batch_size", "4", "--batch_size_val", "4",
       "--num_vertices_to_sample", "32", "--fps_subsampling_factor", "4", "--embedding_dim",
       "24", "--diffusion_timesteps", "5", "--train_iters", "2", "--val_freq", "2",
       "--num_batches_per_test_eval", "1", "--skip_train_val", "1", "--device", "cpu",
       "--checkpoint_backend", "orbax", "--print_progress_freq", "100"]

WORKER = r"""
import os, pickle, sys
import torch

torch.set_num_threads(1)
from nvblox_mindmap_torch.apps import run_training as app
from nvblox_mindmap_torch.data.packed import PackedEpoch, stage_to_device
from nvblox_mindmap_torch.parallel import multihost as mh
from nvblox_mindmap_torch.parallel.mesh import make_data_mesh, maybe_init_distributed, shard_batch
from nvblox_mindmap_torch.training.orbax_checkpoint import OrbaxCheckpointer
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils.logging_utils import MetricLogger

MetricLogger.log_trajectory_figure = lambda self, *a, **k: None
maybe_init_distributed("cpu")
maybe_init_distributed("cpu")  # a second call does nothing
rank = mh.get_rank()
out = {"rank": rank, "world": mh.get_world_size(), "distributed": mh.is_distributed()}
mh.barrier("start")
gathered = mh.all_gather_metrics({"loss": float(rank), "n": 10 * (rank + 1)})
out["gathered"] = [float(g["loss"]) for g in gathered]
out["ns"] = [int(g["n"]) for g in gathered]
out["mean"] = float(mh.mean_metrics_across_processes({"loss": float(rank)})["loss"])
out["broadcast"] = mh.broadcast_object(f"from {rank}")

with open(os.environ["CASE"], "rb") as f:
    case = pickle.load(f)
trainer = Trainer(case["cfg"], TrainerConfig(**case["fields"]), case["bounds"], device="cpu")
trainer.init_state()
trainer.model.load_state_dict(case["state_dict"])
grad_losses = trainer.compute_loss_and_grads(*case["grad_step"])
out["grad_loss"] = float(grad_losses["total"])
out["grads"] = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
                if p.grad is not None}
trainer.optimizer.zero_grad()
out["losses"] = [float(trainer.train_one_step(batch, step, noise, timesteps)["total"])
                 for step, (batch, noise, timesteps) in enumerate(case["steps"])]
out["state_dict"] = trainer.model.state_dict()
out["val_loss"] = trainer.evaluate_nsteps([case["val"]], 1, 1, "val")[0]
# The same batch given as the rank's part already on its device.
out["val_loss_part"] = trainer.evaluate_nsteps(
    [shard_batch(case["val"], make_data_mesh("cpu"))], 1, 1, "val")[0]
ckptr = OrbaxCheckpointer(case["orbax_dir"])
ckptr.save_best_and_last(trainer.model.state_dict(), trainer.optimizer.tensor_state(), 1,
                         out["val_loss"], None)
ckptr.wait()
out["staged_vertices"] = stage_to_device(PackedEpoch(case["packed"]),
                                         mesh=make_data_mesh("cpu"))["vertices"]

# Eval batches of 1, 4 and 3 rows over the 2 ranks: the 1 skipped, the 4
# sharded, the 3 trimmed to 2, each with its warning; DDIM and DDPM (step
# noise).
import dataclasses
import logging

warnings = []
handler = logging.Handler(logging.WARNING)
handler.emit = lambda record: warnings.append(record.getMessage())
logging.getLogger("nvblox_mindmap_torch.trainer").addHandler(handler)
config = trainer.config
out["tail_val_loss"] = {}
for kind in ("ddim", "ddpm"):
    trainer.config = dataclasses.replace(config, eval_scheduler=kind)
    out["tail_val_loss"][kind] = trainer.evaluate_nsteps(case["tail"], 2, -1, "val")[0]
trainer.config = config
out["tail_warnings"] = list(warnings)

# The same batches with the eval step stubbed to a fixed function of the
# rank's rows (STUB_EVAL), the figure recorded: held to JAX's evaluate_nsteps.
exec(case["stub_eval"])


class FigureRecorder:
    figures = []

    def log(self, *args, **kwargs):
        pass

    def log_trajectory_figure(self, pred, gt, step, split):
        self.figures.append(pred)


warnings.clear()
trainer.eval_step = lambda batch, **noise: stub_eval_step(batch, torch.as_tensor)
trainer.metric_logger = FigureRecorder()
out["stub_val"] = trainer.evaluate_nsteps(case["tail"], 2, -1, "val")
out["stub_figures"], out["stub_warnings"] = FigureRecorder.figures, list(warnings)
del trainer.eval_step
trainer.metric_logger = None

recorded = []
step_fn = Trainer.train_one_step


def recording(self, *args, **kwargs):
    losses = step_fn(self, *args, **kwargs)
    recorded.append(float(losses["total"]))
    return losses


Trainer.train_one_step = recording
result = app.main(case["app_argv"])
out["app_losses"], out["app_checkpoint_dir"] = recorded, result["checkpoint_dir"]
out["app_state_dict"] = result["trainer"].model.state_dict()
torch.save(out, os.path.join(os.environ["OUT"], f"rank{rank}.pt"))
"""


STUB_EVAL = r"""
import numpy as np


def stub_eval_step(batch, wrap=lambda x: x):
    # (losses, metrics, predicted positions, ground-truth positions) that
    # depend only on the rows given: the eval loop's trimming, skipping,
    # weighting and figure choice, without the sampler. ``wrap`` makes each
    # array the package's own.
    g = np.asarray(batch["gripper_history"], dtype=np.float64)
    losses = {"total": wrap(g.mean())}
    metrics = {"distance_m": wrap(np.abs(g).mean()),
               "per_gripper": wrap(g.mean(axis=(0, 1))[..., 0])}
    return losses, metrics, wrap(g[..., :3]), wrap(g[..., 3:6])
"""


@pytest.fixture
def no_figures(monkeypatch):
    monkeypatch.setattr(MetricLogger, "log_trajectory_figure", lambda self, *a, **k: None)


def test_multihost_helpers_in_one_process(capsys):
    assert not mh.is_distributed()
    assert (mh.get_rank(), mh.get_world_size()) == (0, 1)
    metrics = {"loss": 0.5, "n": np.asarray([1.0, 2.0])}
    assert mh.all_gather_metrics(metrics) == [metrics]
    mean = mh.mean_metrics_across_processes(metrics)
    assert mean["loss"] == 0.5 and np.array_equal(mean["n"], [1.0, 2.0])
    assert mh.broadcast_object("x") == "x"
    mh.barrier()
    mh.print_dist("rank zero")
    assert capsys.readouterr().out == "rank zero\n"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank launch (see WORKER), run while the references it is held
    to are computed here."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    jcfg, tcfg = configs(8, **SMALL)
    rng = np.random.default_rng(12)
    batches = [mesh_batch(rng, B=8) for _ in range(2)]
    val = mesh_batch(rng, B=4)
    tail = [mesh_batch(rng, B=b) for b in (1, 4, 3)]
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(**FIELDS), BOUNDS,
                          mesh=jax_data_mesh(jax.devices()[:1]))
    params, opt_state = jt.init_state(batches[0])
    flax_init = jax.tree_util.tree_map(np.asarray, params)
    steps = []
    for step, batch in enumerate(batches):  # the JAX trainer's draws
        jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                   jnp.asarray(BOUNDS), jcfg)
        steps.append((batch,) + jax_step_noise(
            jcfg, jprep, jax.random.fold_in(jax.random.PRNGKey(0), step)))
    # One train step of JAX's (loss and gradients) on the first batch.
    grad_ref = jax_train_step(jcfg, flax_init, batches[0], seed=3)
    one = Trainer(tcfg, TrainerConfig(**FIELDS), BOUNDS, device="cpu")
    one.init_state(flax_params=flax_init)
    # A packed epoch for the staging check and the app.
    data = tmp / "ds"
    write_arm_demo(str(data / "demo_00000"), seed=0)
    write_arm_demo(str(data / "demo_00001"), seed=1)
    packed = str(tmp / "packed")
    tpack.main(APP + ["--dataset", str(data), "--packed_out", packed,
                      "--packed_num_batches", "3"])
    app_argv = APP + ["--dataset", str(data), "--packed_dataset", packed]
    case = dict(cfg=tcfg, fields=FIELDS, bounds=BOUNDS, state_dict=one.model.state_dict(),
                steps=steps, grad_step=(batches[0], 0) + grad_ref[2:], val=val, tail=tail,
                stub_eval=STUB_EVAL,
                orbax_dir=str(tmp / "orbax"), packed=packed,
                app_argv=app_argv + ["--base_log_dir", str(tmp / "logs2")])
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    worker = tmp / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, CASE=str(tmp / "case.pkl"), OUT=str(tmp), PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", str(worker)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        # Meanwhile: JAX's single-process trainer and the port in one process,
        # 2 steps over the 8-row batches.
        jax_losses = []
        for step, batch in enumerate(batches):
            params, opt_state, losses = jt.train_one_step(params, opt_state, batch, step)
            jax_losses.append(float(np.asarray(losses["total"])))
        one_losses = [float(one.train_one_step(batch, step, noise, timesteps)["total"])
                      for step, (batch, noise, timesteps) in enumerate(steps)]
        one_val_loss = one.evaluate_nsteps([val], 1, 1, "val")[0]
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, jcfg=jcfg, tcfg=tcfg, jax_losses=jax_losses, one=one, one_losses=one_losses,
                jax_grad_loss=float(np.asarray(grad_ref[0]["total"])),
                jax_grads=flax_to_state_dict(grad_ref[1]),
                one_val_loss=one_val_loss, tail=tail, packed=packed, orbax_dir=case["orbax_dir"],
                app_argv=app_argv, tmp=tmp)


def test_two_ranks_gather_mean_and_barrier(two_ranks):
    for r, res in enumerate(two_ranks["ranks"]):
        assert (res["rank"], res["world"], res["distributed"]) == (r, 2, True)
        assert res["gathered"] == [0.0, 1.0] and res["ns"] == [10, 20]
        assert res["mean"] == 0.5
        assert res["broadcast"] == "from 0"


def test_two_ranks_train_like_one_and_like_jax(two_ranks):
    one, ranks = two_ranks["one"], two_ranks["ranks"]
    lr = FIELDS["initial_learning_rate"]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], two_ranks["one_losses"], atol=1e-6, rtol=0)
        for name, value in one.model.state_dict().items():
            torch.testing.assert_close(res["state_dict"][name], value, rtol=0, msg=name,
                                       atol=lr if "k_proj.bias" in name else 1e-6)
    for name, value in ranks[0]["state_dict"].items():  # the ranks stay identical
        assert torch.equal(value, ranks[1]["state_dict"][name]), name
    np.testing.assert_allclose(ranks[0]["losses"], two_ranks["jax_losses"], rtol=1e-5, atol=0)
    for res in ranks:  # one step's loss and averaged gradients vs jax.value_and_grad
        np.testing.assert_allclose(res["grad_loss"], two_ranks["jax_grad_loss"], rtol=1e-5,
                                   atol=0)
        assert len(res["grads"]) > 50
        for name, grad in res["grads"].items():
            torch.testing.assert_close(grad, two_ranks["jax_grads"][name], atol=1e-5,
                                       rtol=1e-4, msg=name)


def test_two_ranks_stage_their_rows(two_ranks):
    from nvblox_mindmap_torch.data.packed import PackedEpoch

    full = PackedEpoch(two_ranks["packed"]).arrays["vertices"]
    for r, res in enumerate(two_ranks["ranks"]):
        np.testing.assert_array_equal(res["staged_vertices"].numpy(), full[:, 2 * r:2 * r + 2])


def test_two_ranks_save_asynchronously_and_restore(two_ranks):
    """The collective save: best/ and last/ restore, bit for bit, into one
    process; the eval loss averaged over the ranks is the one process's
    (whose parameters differ by rounding: rtol 1e-6), and each rank given its
    part of the batch on its device gives the same loss."""
    ranks = two_ranks["ranks"]
    assert ranks[0]["val_loss"] == ranks[1]["val_loss"]
    assert ranks[0]["val_loss_part"] == ranks[0]["val_loss"]  # each rank's part on its device
    np.testing.assert_allclose(ranks[0]["val_loss"], two_ranks["one_val_loss"], rtol=1e-6)
    assert sorted(os.listdir(two_ranks["orbax_dir"])) == ["best", "last"]
    for name in ("best", "last"):
        trainer = Trainer(two_ranks["tcfg"], TrainerConfig(**FIELDS), BOUNDS, device="cpu")
        step, best = trainer.load_checkpoint(os.path.join(two_ranks["orbax_dir"], name))
        assert (step, best) == (1, ranks[0]["val_loss"])
        assert trainer.optimizer.count == 2
        for key, value in trainer.model.state_dict().items():
            assert torch.equal(value, ranks[0]["state_dict"][key]), key


def test_two_ranks_shard_eval_batches_and_trim_the_tail(two_ranks):
    """Each rank evaluates its rows of every eval batch; a batch that does
    not divide over the 2 ranks is trimmed (3 -> 2 rows), one smaller than
    the ranks is skipped, with the warnings of the stubbed run (held to
    JAX's in the next test); each kept batch's loss is the one process's on
    its kept rows with the same noise, weighted by its kept rows."""
    one = two_ranks["one"]
    config = one.config
    try:
        for kind in ("ddim", "ddpm"):
            one.config = dataclasses.replace(config, eval_scheduler=kind)
            weighted, rows = 0.0, 0
            for i, batch in enumerate(two_ranks["tail"]):
                keep = batch["gripper_history"].shape[0] // 2 * 2
                if keep == 0:
                    continue
                losses = one.eval_step({k: v[:keep] for k, v in batch.items()},
                                       generator=one._generator(config.seed + 17, 2000 + i))[0]
                weighted += float(losses["total"]) * keep
                rows += keep
            for res in two_ranks["ranks"]:
                np.testing.assert_allclose(res["tail_val_loss"][kind], weighted / rows,
                                           rtol=1e-6, atol=0)
    finally:
        one.config = config
    for res in two_ranks["ranks"]:
        assert res["tail_warnings"] == res["stub_warnings"] * 2


def test_two_ranks_eval_loop_is_jaxs_over_a_two_device_mesh(two_ranks):
    """The eval loop with its step stubbed to a fixed function of the rows it
    is given (STUB_EVAL), over the same batches of 1, 4 and 3 rows: the port
    on 2 ranks and the JAX trainer's ``evaluate_nsteps`` over a 2-device CPU
    mesh skip and trim alike, with the same warnings, the same loss and
    metrics weighted by the kept rows (float64: rtol 1e-12), and the
    figure of the first evaluated batch (the port logs rank 0's rows)."""
    stub = {}
    exec(STUB_EVAL, stub)
    figures, warnings = [], []

    class FigureRecorder:
        def log(self, *args, **kwargs):
            pass

        def log_trajectory_figure(self, pred, gt, step, split):
            figures.append(np.asarray(pred))

    jt = jtrainer.Trainer(two_ranks["jcfg"], jtrainer.TrainerConfig(**FIELDS), BOUNDS,
                          mesh=jax_data_mesh(jax.devices()[:2]))
    jt._eval_step = lambda params, batch, rng: stub["stub_eval_step"](batch)
    jt.metric_logger = FigureRecorder()
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    jax_logger = logging.getLogger("nvblox_mindmap_tpu.trainer")
    jax_logger.addHandler(handler)
    try:
        jax_loss, jax_metrics = jt.evaluate_nsteps(None, two_ranks["tail"], 2, -1, "val")
    finally:
        jax_logger.removeHandler(handler)
    assert len(warnings) == 2 and len(figures) == 1
    for res in two_ranks["ranks"]:
        assert res["stub_warnings"] == warnings
        loss, metrics = res["stub_val"]
        np.testing.assert_allclose(loss, jax_loss, rtol=1e-12, atol=0)
        assert sorted(metrics) == sorted(jax_metrics)
        for k in metrics:
            np.testing.assert_allclose(metrics[k], jax_metrics[k], rtol=1e-12, atol=0)
    rank0, rank1 = (res["stub_figures"] for res in two_ranks["ranks"])
    assert rank1 == [] and len(rank0) == 1
    np.testing.assert_array_equal(rank0[0], figures[0][:len(figures[0]) // 2])


def test_the_app_under_torchrun_trains_like_one_process(two_ranks, no_figures):
    """The app, packed, 2 ranks x 2 rows against 1 process x 4 rows: the
    same losses and final parameters; then a resume from the 2-rank run's
    last/ continues from its iteration."""
    ranks = two_ranks["ranks"]
    one = tapp.main(two_ranks["app_argv"] + ["--base_log_dir", str(two_ranks["tmp"] / "logs1")])
    ckpt_dir = ranks[0]["app_checkpoint_dir"]
    assert ranks[1]["app_checkpoint_dir"] == ckpt_dir
    assert {"best", "last", "training_args.json"} <= set(os.listdir(ckpt_dir))
    assert os.path.realpath(os.path.join(os.path.dirname(ckpt_dir), "latest")) == ckpt_dir
    reference = one["trainer"].model.state_dict()
    for res in ranks:
        assert len(res["app_losses"]) == 2
        for name, value in reference.items():
            torch.testing.assert_close(res["app_state_dict"][name], value, atol=1e-6, rtol=0,
                                       msg=name)
    resumed = tapp.main(two_ranks["app_argv"] + [
        "--base_log_dir", str(two_ranks["tmp"] / "logs3"), "--train_iters", "3",
        "--checkpoint", os.path.join(ckpt_dir, "last")])
    assert resumed["start_iter"] == 1 and resumed["trainer"].optimizer.count == 2 + 2


# ------------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def serving_case():
    """The JAX serving test's model and batch, its flax init, and the port's
    model with those weights."""
    model = small_model()
    batch = serving_batch(8)
    _, _, params = init_jax(model.config, {k: v[:1] for k, v in batch.items()}, BOUNDS)
    tcfg = tda.DiffuserActorConfig(data_type="mesh", vertex_feature_dim=8, embedding_dim=24,
                                   num_attn_heads=4, diffusion_timesteps=4,
                                   fps_subsampling_factor=4)
    tmodel = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(tmodel, params)
    return model, batch, params, tmodel


def test_serving_matches_jax_on_its_eight_devices(serving_case):
    model, batch, params, tmodel = serving_case
    key = jax.random.PRNGKey(0)
    ref = jax_infer_fn(model, jnp.asarray(BOUNDS), jax_data_mesh())(params, batch, key)
    init, steps = jax_sampler_noise(key, 4, (8, 1, 1))
    infer = make_sharded_infer_fn(tmodel, BOUNDS, ["cpu"])
    traj, _, weights = infer(tmodel.state_dict(), batch, init_noise=init, step_noise=steps)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(weights.numpy(), np.asarray(ref[2]), atol=1e-5, rtol=0)


def test_serving_over_two_devices_equals_one_call(serving_case):
    _, batch, _, tmodel = serving_case
    params = tmodel.state_dict()
    one = make_sharded_infer_fn(tmodel, BOUNDS, ["cpu"])
    two = make_sharded_infer_fn(tmodel, BOUNDS, ["cpu", "cpu"])
    gen = torch.Generator().manual_seed(3)
    a = one(params, batch, generator=gen)
    b = two(params, batch, generator=torch.Generator().manual_seed(3))
    assert a[1] is None and b[1] is None  # no head yaw
    for x, y in (a[0], b[0]), (a[2], b[2]):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-6, rtol=0)
    assert two.copies == 1  # one replica per device, made once


def test_serving_rejects_indivisible_batch_and_serves_ddim(serving_case):
    _, batch, _, tmodel = serving_case
    params = tmodel.state_dict()
    infer = make_sharded_infer_fn(tmodel, BOUNDS, ["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        infer(params, serving_batch(6), generator=torch.Generator())
    ddim = make_sharded_infer_fn(tmodel, BOUNDS, ["cpu", "cpu"],
                                 **convert_diffusion_scheduler(2))
    traj, _, _ = ddim(params, batch, init_noise=torch.randn(8, 1, 1, 9))
    assert traj.shape == (8, 1, 1, 8) and bool(torch.isfinite(traj).all())


def test_serving_copies_parameters_once_per_object(serving_case):
    _, batch, _, tmodel = serving_case
    infer = make_sharded_infer_fn(tmodel, BOUNDS, ["cpu"], **convert_diffusion_scheduler(2))
    params = tmodel.state_dict()
    noise = torch.randn(8, 1, 1, 9)
    first = infer(params, batch, init_noise=noise)[0]
    for _ in range(2):
        assert torch.equal(infer(params, batch, init_noise=noise)[0], first)
    assert infer.copies == 1
    changed = {k: v + 0.01 if v.is_floating_point() else v for k, v in params.items()}
    assert not torch.equal(infer(changed, batch, init_noise=noise)[0], first)
    assert infer.copies == 2
