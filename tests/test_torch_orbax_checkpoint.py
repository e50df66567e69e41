"""The port's asynchronous checkpoint backend (``--checkpoint_backend orbax``).

Its contract is the JAX package's ``OrbaxCheckpointer`` (``tests/
test_orbax_checkpoint.py``): best/ and last/ directories, last keeps the
running best, a NaN best reads back as None. Here: the round trip after
``wait`` (bit for bit), a write that becomes visible under its name only
once it is whole, a run resumed from ``last/`` equal to the uninterrupted
run. A directory written by the JAX package's backend (orbax and
tensorstore are installed here) restores without tensorstore: its params
bit for bit, and from the JAX trainer's checkpoint after 3 updates the
port's next update within 1e-6 of JAX's (as ``tests/test_torch_training.py``
holds the msgpack route); the OCDBT reader gives tensorstore's own reads on
stores with out-of-line values, interior B-tree nodes, zstd at another level
and no compression; a layout it does not know raises naming what it found.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.training import optimizer as jopt
from nvblox_mindmap_tpu.training import trainer as jtrainer
from nvblox_mindmap_tpu.training.orbax_checkpoint import OrbaxCheckpointer as JaxCheckpointer
from nvblox_mindmap_torch.data.sampler import WeightedEpochSampler
from nvblox_mindmap_torch.models.weights import flax_to_state_dict
from nvblox_mindmap_torch.training.orbax_checkpoint import (
    OrbaxCheckpointer,
    read_ocdbt,
    read_orbax_tree,
)
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from tests.test_torch_model_parity import BOUNDS, configs
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_training import (
    SMALL,
    InMemoryLoader,
    Interrupted,
    jax_step_noise,
    mesh_batch,
)


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
    """A JAX-written directory now restores (bit for bit, best and last,
    asynchronous and synchronous writes); one whose layout the reader does
    not know raises and names what it found (another OCDBT format version,
    zarr v3, a codec), and a missing directory raises."""
    params = {"a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                    "bias": np.linspace(0, 1, 4, dtype=np.float32)},
              "big": np.random.default_rng(0).normal(size=(40, 70)).astype(np.float32)}
    opt = {"m": np.zeros(3, np.float32), "count": np.int32(7)}
    for async_write in (True, False):
        directory = tmp_path / f"async_{async_write}"
        jckpt = JaxCheckpointer(str(directory), async_write=async_write)
        jckpt.save_best_and_last(params, opt, 4, 0.5, None)
        jckpt.save_best_and_last(params, opt, 5, None, 0.5)
        jckpt.wait()
        for name, step in (("best", 4), ("last", 5)):
            restored = read_orbax_tree(str(directory / name))
            assert restored["meta"] == {"iter": step, "best_loss": 0.5}
            for key in ("kernel", "bias"):
                assert np.array_equal(restored["params"]["a"][key], params["a"][key])
            assert np.array_equal(restored["params"]["big"], params["big"])
            assert restored["opt_state"]["count"] == 7
    with pytest.raises(FileNotFoundError):
        OrbaxCheckpointer(str(tmp_path)).restore("missing", *tree(0))

    best = tmp_path / "async_False" / "best"
    manifest = (best / "manifest.ocdbt").read_bytes()
    (best / "manifest.ocdbt").write_bytes(manifest[:12] + b"\x01" + manifest[13:])
    with pytest.raises(ValueError, match="OCDBT format version 1"):
        read_orbax_tree(str(best))
    last = tmp_path / "async_False" / "last"
    metadata = json.loads((last / "_METADATA").read_text())
    (last / "_METADATA").write_text(json.dumps(dict(metadata, use_zarr3=True)))
    with pytest.raises(ValueError, match="use_zarr3=True"):
        read_orbax_tree(str(last))
    (last / "_METADATA").write_text(json.dumps(metadata))
    store = dict(read_ocdbt(str(last)))
    zarray = json.loads(store["params.big/.zarray"])
    assert zarray["compressor"]["id"] == "zstd" and zarray["dtype"] == "<f4"


def _tensorstore_kv(path, config, items):
    import tensorstore as ts

    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                             "config": config}).result()
    for key, value in items.items():
        store.write(key, value).result()
    reopened = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    return {k.decode(): reopened.read(k).result().value for k in reopened.list().result()}


@pytest.mark.parametrize("layout", ["out_of_line_values", "interior_nodes", "zstd_level_5",
                                    "uncompressed"])
def test_ocdbt_reader_matches_tensorstore(tmp_path, layout):
    """Stores written by tensorstore itself, one layout each: values above
    the inline limit in data files, a B-tree of height > 0 (small nodes,
    each subtree with a common key prefix), another zstd level, no
    compression; every key written one commit at a time (many versions)."""
    rng = np.random.default_rng(1)
    config, items = {
        "out_of_line_values": ({}, {f"key{i:03d}": rng.bytes(3000 if i % 3 == 0 else 50)
                                    for i in range(40)}),
        "interior_nodes": ({"max_decoded_node_bytes": 600},
                           {f"k{i:04d}": rng.bytes(40) for i in range(200)}),
        "zstd_level_5": ({"compression": {"id": "zstd", "level": 5}},
                         {"a": b"hello", "b": b"x" * 10}),
        "uncompressed": ({"compression": None}, {"a": b"hello", "b": b"world"}),
    }[layout]
    want = _tensorstore_kv(tmp_path, config, items)
    assert want == items
    assert dict(read_ocdbt(str(tmp_path))) == want


@pytest.mark.parametrize("accumulate", [1, 2])
def test_resume_from_a_jax_orbax_directory_matches_jax(tmp_path, accumulate):
    """The JAX trainer takes 3 updates (with 2-step accumulation: 3 updates
    and one pending micro-step) and its orbax backend saves ``last/``; the
    port restores it (the params bit for bit, the Adam moments, count and
    accumulation), and its next update on the same batch, noise and
    timesteps matches the JAX trainer's within 1e-6 (the attention
    k-projection biases, whose gradient is zero up to rounding, within one
    step, lr)."""
    jcfg, tcfg = configs(8, **SMALL)
    rng = np.random.default_rng(12)
    batches = [mesh_batch(rng) for _ in range(4)]
    fields = dict(batch_size=2, train_iters=8, initial_learning_rate=1e-3,
                  accumulate_grad_batches=accumulate)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(**fields), BOUNDS)
    params, opt_state = jt.init_state(batches[0])
    n = 3 * accumulate + (accumulate - 1)
    for step in range(n):
        params, opt_state, _ = jt.train_one_step(params, opt_state, batches[step % 4], step)
    jckpt = JaxCheckpointer(str(tmp_path))
    jckpt.save("last", params, opt_state, n - 1, 0.5)
    jckpt.wait()
    saved = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    batch = batches[n % 4]
    noise, timesteps = jax_step_noise(
        jcfg, jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(BOUNDS), jcfg),
        jax.random.fold_in(jax.random.PRNGKey(0), n))
    params, _, _ = jt.train_one_step(params, opt_state, batch, n)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))

    trainer = Trainer(tcfg, TrainerConfig(**fields), BOUNDS, device="cpu")
    assert trainer.load_checkpoint(str(tmp_path / "last")) == (n - 1, 0.5)
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, saved[name]), name
    optimizer = trainer.optimizer
    assert (optimizer.count, optimizer.mini_step) == (3, accumulate - 1)
    lr = float(jopt.linear_lr_schedule(1e-3, 0.5, 8)(3))
    trainer.train_one_step(batch, n, noise, timesteps)
    assert optimizer.count == 4
    for name, value in trainer.model.state_dict().items():
        atol = lr if "k_proj.bias" in name else 1e-6
        torch.testing.assert_close(value, ref[name], atol=atol, rtol=0, msg=name)
