"""The port's asynchronous checkpoint backend (``--checkpoint_backend orbax``).

Its contract is the JAX package's ``OrbaxCheckpointer`` (``tests/
test_orbax_checkpoint.py``): best/ and last/ directories, last keeps the
running best, a NaN best reads back as None. Here: the round trip after
``wait`` (bit for bit), a write that becomes visible under its name only
once it is whole, a run resumed from ``last/`` equal to the uninterrupted
run, and an orbax directory written by the JAX package (orbax and
tensorstore are installed here) refused with its reason.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvblox_mindmap_tpu.training.orbax_checkpoint import OrbaxCheckpointer as JaxCheckpointer
from nvblox_mindmap_torch.data.sampler import WeightedEpochSampler
from nvblox_mindmap_torch.training.orbax_checkpoint import OrbaxCheckpointer
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from tests.test_torch_model_parity import BOUNDS, configs
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_training import SMALL, InMemoryLoader, Interrupted, mesh_batch


def tree(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 3, generator=g), "b": torch.randn(3, generator=g)}
    opt = {"m": {"w": torch.randn(3, 3, generator=g)}, "count": 4 + seed}
    return params, opt


@pytest.mark.parametrize("async_write", [True, False])
def test_best_last_roundtrip(tmp_path, async_write):
    ckpt = OrbaxCheckpointer(str(tmp_path), async_write=async_write)
    params, opt = tree(0)
    assert ckpt.save_best_and_last(params, opt, 10, 0.7, None) == 0.7
    worse_params, worse_opt = tree(1)
    # A worse loss updates last (with the running best) but not best.
    assert ckpt.save_best_and_last(worse_params, worse_opt, 20, 0.9, 0.7) == 0.7
    ckpt.wait()
    assert sorted(os.listdir(tmp_path)) == ["best", "last"]
    for name, (want_params, want_opt, want_step) in (("best", (params, opt, 10)),
                                                     ("last", (worse_params, worse_opt, 20))):
        p, o = tree(5)
        p, o, step, best = ckpt.restore(name, p, o)
        assert (step, best) == (want_step, 0.7)
        assert o["count"] == want_opt["count"]
        for key in ("w", "b"):
            assert torch.equal(p[key], want_params[key]), key
        assert torch.equal(o["m"]["w"], want_opt["m"]["w"])


def test_nan_best_reads_back_as_none_and_writes_land_whole(tmp_path):
    ckpt = OrbaxCheckpointer(str(tmp_path))
    params, opt = tree(0)
    assert ckpt.save_best_and_last(params, opt, 3, None, None) is None
    # Not under its name before the write is waited for, then only there.
    assert not os.path.exists(tmp_path / "last")
    ckpt.wait()
    assert sorted(os.listdir(tmp_path)) == ["last"]
    _, _, step, best = ckpt.restore("last", *tree(2))
    assert (step, best) == (3, None)


def test_resume_from_last_equals_continuing(tmp_path):
    """8 steps straight through vs a run cut after its checkpoint at step 3
    and resumed from last/ by a new trainer: the same parameters and Adam
    state (as ``tests/test_torch_training.py`` holds for the msgpack
    files)."""
    _, tcfg = configs(8, **SMALL)
    rng = np.random.default_rng(10)
    pool = mesh_batch(rng, B=8)
    val = [mesh_batch(rng)]

    def run(directory, stop_at_epoch=None, resume=None):
        fields = dict(train_iters=8, batch_size=2, val_freq=4, skip_train_val=True,
                      set_epoch_every=2, checkpoint_dir=str(directory),
                      eval_num_inference_steps=2, checkpoint_backend="orbax")
        trainer = Trainer(tcfg, TrainerConfig(**fields), BOUNDS, device="cpu")
        start_iter = 0
        if resume:
            step, _ = trainer.load_checkpoint(resume)
            start_iter = step + 1
        sampler = WeightedEpochSampler(np.ones(8), num_samples=4, replacement=True, seed=3)
        try:
            trainer.run_training(InMemoryLoader(pool, 2, sampler, stop_at_epoch), val,
                                 start_iter=start_iter)
        finally:
            if trainer._orbax is not None:
                trainer._orbax.wait()
        return trainer

    straight = run(tmp_path / "a")
    assert sorted(os.listdir(tmp_path / "a")) == ["best", "last"]
    with pytest.raises(Interrupted):
        run(tmp_path / "b", stop_at_epoch=2)
    resumed = run(tmp_path / "c", resume=str(tmp_path / "b" / "last"))
    assert resumed.optimizer.count == straight.optimizer.count == 8
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.optimizer.tensor_state()["exp_avg_sq"].values(),
                    resumed.optimizer.tensor_state()["exp_avg_sq"].values()):
        assert torch.equal(a, b)


def test_a_jax_written_orbax_directory_raises_with_its_reason(tmp_path):
    JaxCheckpointer(str(tmp_path), async_write=False).save_best_and_last(
        {"w": jnp.ones((3, 3))}, {"m": jnp.zeros(3)}, 4, 0.5, None)
    with pytest.raises(NotImplementedError, match="tensorstore"):
        OrbaxCheckpointer(str(tmp_path)).restore("best", *tree(0))
    _, tcfg = configs(8, **SMALL)
    trainer = Trainer(tcfg, TrainerConfig(), BOUNDS, device="cpu")
    with pytest.raises(NotImplementedError, match="JAX package's orbax"):
        trainer.load_checkpoint(str(tmp_path / "last"))
    with pytest.raises(FileNotFoundError):
        OrbaxCheckpointer(str(tmp_path)).restore("missing", *tree(0))
