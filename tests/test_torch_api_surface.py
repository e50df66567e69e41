"""Torch port vs the JAX package: the rest of the JAX package's public surface.

The same numpy inputs go through each JAX function and its port, with
weights converted from the flax tree by the port's bridge:
``MultiheadAttention``'s variants (slot competition, gated memory with and
without its mask, ``return_kv``) and their routing under the flash impl,
``Encoder.encode_goal_gripper``, the six rotation conversions over every
Euler convention, ``rotary_pe_1d``, ``includes_nvblox``, the timers and
``MetricLogger.log_timings``, ``ProfilerTrace``, flax's chunked msgpack form
and the bench-table renderer.

Tolerance: 1e-5 in fp32 (the two sides sum in different orders).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.data import data_types as jtypes
from nvblox_mindmap_tpu.geometry import rotations as jrot
from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.models import layers as jlayers
from nvblox_mindmap_tpu.ops.positional import rotary_pe_1d as jax_rotary_1d
from nvblox_mindmap_tpu.ops.positional import rotary_pe_3d as jax_rotary_3d
from nvblox_mindmap_tpu.scripts import checkpoint_tools as jtools
from nvblox_mindmap_tpu.scripts import render_bench_table as jbench
from nvblox_mindmap_tpu.training.checkpoint import save_checkpoint_file as jax_save
from nvblox_mindmap_tpu.training.optimizer import _decay_mask as jax_decay_mask
from nvblox_mindmap_tpu.utils import logging_utils as jlogging
from nvblox_mindmap_tpu.utils import timers as jtimers
from nvblox_mindmap_torch.data import data_types as ttypes
from nvblox_mindmap_torch.geometry import rotations as trot
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models import layers as tlayers
from nvblox_mindmap_torch.models.weights import flax_paths, load_flax_params, state_dict_to_flax
from nvblox_mindmap_torch.ops import flash_attention as fa
from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
from nvblox_mindmap_torch.ops.positional import rotary_pe_1d
from nvblox_mindmap_torch.scripts import checkpoint_tools as ttools
from nvblox_mindmap_torch.scripts import render_bench_table as tbench
from nvblox_mindmap_torch.training import checkpoint as tckpt
from nvblox_mindmap_torch.training.optimizer import decay_mask
from nvblox_mindmap_torch.utils import logging_utils as tlogging
from nvblox_mindmap_torch.utils import timers as ttimers
from tests.test_torch_model_parity import BOUNDS, SMALL, SMALL_FEATURES, configs, make_batch

ATOL = 1e-5
B, L, S, E, H, S_MEM = 2, 5, 11, 24, 4, 7


@pytest.fixture(autouse=True)
def restore_impl():
    yield
    set_default_attention_impl("eager")


# ------------------------------------------------------- MultiheadAttention

VARIANTS = {
    "plain": dict(),
    "slot_competition": dict(module=dict(slot_competition=True)),
    "gate_memory": dict(module=dict(gate_attn=True), memory=True),
    "gate_memory_mem_mask": dict(module=dict(gate_attn=True), memory=True, mem_mask=True),
    "return_kv": dict(return_kv=True),
    "all": dict(module=dict(slot_competition=True, gate_attn=True), memory=True,
                mem_mask=True, return_kv=True),
}


def _attention_inputs(seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(B, S)) > 0.6  # exclusion: True = ignore
    mask[:, 0] = False  # every row keeps a valid key
    return {
        "q": rng.normal(size=(B, L, E)).astype(np.float32),
        "kv": rng.normal(size=(B, S, E)).astype(np.float32),
        "mask": mask,
        "q_code": np.array(jax_rotary_3d(jnp.asarray(rng.uniform(-1, 1, (B, L, 3))), E)),
        "k_code": np.array(jax_rotary_3d(jnp.asarray(rng.uniform(-1, 1, (B, S, 3))), E)),
        "k_mem": rng.normal(size=(B, S_MEM, E)).astype(np.float32),
        "v_mem": rng.normal(size=(B, S_MEM, E)).astype(np.float32),
        "mem_mask": (rng.uniform(size=(B, S_MEM)) > 0.3).astype(np.float32),
    }


def _attention_args(x, opts, to):
    kwargs = dict(rotary_codes=(to(x["q_code"]), to(x["k_code"])),
                  key_padding_mask=to(x["mask"]), return_kv=opts.get("return_kv", False))
    if opts.get("memory"):
        kwargs.update(k_mem=to(x["k_mem"]), v_mem=to(x["v_mem"]))
        if opts.get("mem_mask"):
            kwargs["mem_mask"] = to(x["mem_mask"])
    return (to(x["q"]), to(x["kv"]), to(x["kv"])), kwargs


def _jax_attention(opts, x, seed=0):
    """(params, outputs) of the JAX module with this variant."""
    module = jlayers.MultiheadAttention(E, H, **opts.get("module", {}))
    args, kwargs = _attention_args(x, opts, jnp.asarray)
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return params, module.apply({"params": params}, *args, **kwargs)


def _port_attention(opts, params):
    module = tlayers.MultiheadAttention(E, H, **opts.get("module", {}))
    load_flax_params(module, params)
    return module


def _assert_results_close(out, ref):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_multihead_attention_variant_matches_jax(variant):
    opts = VARIANTS[variant]
    x = _attention_inputs(seed=len(variant))
    params, ref = _jax_attention(opts, x)
    module = _port_attention(opts, params)
    args, kwargs = _attention_args(x, opts, torch.from_numpy)
    out = module(*args, **kwargs)
    if opts.get("return_kv"):
        assert len(out) == 4 and out[1].shape == (B, L, H, E // H)
    _assert_results_close(out, ref)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_multihead_attention_variant_never_reaches_the_kernel(variant, monkeypatch):
    """Under the flash impl a call with any variant takes the eager path (no
    kernel call, the eager result exactly); only the plain call reaches the
    kernel (its plain version on the CPU), once."""
    opts = VARIANTS[variant]
    x = _attention_inputs(seed=3)
    params, _ = _jax_attention(opts, x)
    module = _port_attention(opts, params)
    args, kwargs = _attention_args(x, opts, torch.from_numpy)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        eager = module(*args, need_weights=False, impl="eager", **kwargs)
        set_default_attention_impl("flash")
        flash = module(*args, **kwargs)
    assert len(calls) == (1 if variant == "plain" else 0)
    if not opts.get("return_kv"):
        assert flash[1] is None and eager[1] is None
    if variant == "plain":
        torch.testing.assert_close(flash[0], eager[0], rtol=0, atol=ATOL)
    else:
        assert all(torch.equal(a, b) for a, b in zip(flash, eager) if a is not None)


def test_gate_attn_parameter_loads_strictly_and_inverts():
    opts = VARIANTS["gate_memory"]
    params, _ = _jax_attention(opts, _attention_inputs(seed=1))
    assert params["gate_attn"].shape == (H,)
    module = _port_attention(opts, params)
    assert isinstance(module.gate_attn, torch.nn.Parameter) and module.gate_attn.requires_grad
    np.testing.assert_array_equal(module.gate_attn.detach().numpy(), params["gate_attn"])
    assert flax_paths(module)["gate_attn"] == ("gate_attn",)
    back = state_dict_to_flax(module.state_dict())
    assert sorted(back) == sorted(params)
    for name in params:
        for leaf in params[name] if isinstance(params[name], dict) else [None]:
            got = back[name] if leaf is None else back[name][leaf]
            want = params[name] if leaf is None else params[name][leaf]
            np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="unexpected.*gate_attn"):
        load_flax_params(tlayers.MultiheadAttention(E, H), params)
    without = {k: v for k, v in params.items() if k != "gate_attn"}
    with pytest.raises(KeyError, match="missing.*gate_attn"):
        load_flax_params(tlayers.MultiheadAttention(E, H, gate_attn=True), without)


def test_gate_attn_is_decayed_as_jax_decays_it():
    opts = VARIANTS["gate_memory"]
    params, _ = _jax_attention(opts, _attention_inputs(seed=2))
    module = _port_attention(opts, params)
    jax_mask = jax_decay_mask(params)
    paths = flax_paths(module)
    mask = decay_mask(module)
    assert mask["gate_attn"] is True
    for name, path in paths.items():
        node = jax_mask
        for part in path:
            node = node[part]
        assert mask[name] == bool(node), name


def test_gate_attn_is_initialised_as_flax_normal():
    torch.manual_seed(0)
    gates = torch.cat([tlayers.MultiheadAttention(8, 8, gate_attn=True).gate_attn.detach()
                       for _ in range(200)])
    assert abs(gates.mean().item()) < 0.1 and abs(gates.std().item() - 1.0) < 0.1
    assert tlayers.MultiheadAttention(8, 8).gate_attn is None


# --------------------------------------------------------- the goal gripper


@pytest.fixture(scope="module")
def goal_models():
    jcfg, tcfg = configs(SMALL_FEATURES, **SMALL)
    rng = np.random.default_rng(0)
    batch = make_batch(rng, 2, 2, 32, SMALL_FEATURES, BOUNDS)
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(BOUNDS), jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jprep,
                                     jnp.zeros((2, 1, 2, 9)), jnp.zeros((2,), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel


def test_encode_goal_gripper_matches_jax(goal_models, monkeypatch):
    """Against JAX's on converted weights; under the flash impl each of the
    3 layers is one kernel call (1 query over the whole context, no mask)."""
    jmodel, params, tmodel = goal_models
    rng = np.random.default_rng(5)
    E_model = SMALL["embedding_dim"]
    goal = rng.uniform(-0.5, 1.0, size=(3, 8)).astype(np.float32)
    feats = rng.normal(size=(3, 40, E_model)).astype(np.float32)
    context = rng.uniform(-0.5, 1.0, size=(3, 40, 3)).astype(np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(goal), jnp.asarray(feats),
                       jnp.asarray(context),
                       method=lambda m, g, f, c: m.encoder.encode_goal_gripper(g, f, c))
    args = (torch.from_numpy(goal), torch.from_numpy(feats), torch.from_numpy(context))
    calls = []
    real = fa.flash_attention

    def counting(q, k, v, key_padding_mask=None):
        calls.append((q.shape, k.shape, key_padding_mask))
        return real(q, k, v, key_padding_mask)

    monkeypatch.setattr(fa, "flash_attention", counting)
    with torch.no_grad():
        out = tmodel.encoder.encode_goal_gripper(*args)
        flash = tmodel.encoder.encode_goal_gripper(*args, impl="flash")
    assert out[0].shape == (3, 1, E_model) and out[1].shape == (3, 1, E_model, 2)
    _assert_results_close(out, ref)
    _assert_results_close(flash, ref)
    heads = SMALL["num_attn_heads"]
    head_dim = E_model // heads
    assert calls == [((3, heads, 1, head_dim), (3, heads, 40, head_dim), None)] * 3


# ---------------------------------------------------------------- rotations

CONVENTIONS = ("XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX",
               "XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ")


def _quaternions(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_quaternion_apply_and_axis_angle_match_jax():
    rng = np.random.default_rng(0)
    q = _quaternions(rng, 64)
    points = rng.normal(size=(64, 3)).astype(np.float32)
    _close(trot.quaternion_apply(torch.from_numpy(q), torch.from_numpy(points)),
           jrot.quaternion_apply(jnp.asarray(q), jnp.asarray(points)))
    axis_angle = rng.normal(size=(64, 3)).astype(np.float32)
    axis_angle[:4] *= 1e-7  # the Taylor branch below an angle of 1e-6
    for name in ("axis_angle_to_quaternion", "axis_angle_to_matrix"):
        _close(getattr(trot, name)(torch.from_numpy(axis_angle)),
               getattr(jrot, name)(jnp.asarray(axis_angle)))
    matrices = np.array(jrot.quaternion_to_matrix(jnp.asarray(q)))
    _close(trot.matrix_to_axis_angle(torch.from_numpy(matrices)),
           jrot.matrix_to_axis_angle(jnp.asarray(matrices)))
    with pytest.raises(ValueError, match="not 3D"):
        trot.quaternion_apply(torch.from_numpy(q), torch.zeros(64, 4))


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_angles_match_jax(convention):
    rng = np.random.default_rng(len(convention) + CONVENTIONS.index(convention))
    angles = rng.uniform(-np.pi, np.pi, size=(64, 3)).astype(np.float32)
    _close(trot.euler_angles_to_matrix(torch.from_numpy(angles), convention),
           jrot.euler_angles_to_matrix(jnp.asarray(angles), convention))
    matrices = np.array(jrot.quaternion_to_matrix(jnp.asarray(_quaternions(rng, 64))))
    out = trot.matrix_to_euler_angles(torch.from_numpy(matrices), convention)
    _close(out, jrot.matrix_to_euler_angles(jnp.asarray(matrices), convention))
    # And the angles give the matrices back.
    _close(trot.euler_angles_to_matrix(out, convention), matrices, atol=1e-4)


def test_euler_conventions_are_checked():
    for bad in ("XY", "XYW", "ABC"):
        with pytest.raises(ValueError, match="Invalid convention"):
            trot.euler_angles_to_matrix(torch.zeros(3), bad)
        with pytest.raises(ValueError, match="Invalid convention"):
            trot.matrix_to_euler_angles(torch.eye(3), bad)


def test_package_exports_match_jax():
    import nvblox_mindmap_torch.embodiments as tembodiments
    import nvblox_mindmap_torch.geometry as tgeometry
    import nvblox_mindmap_tpu.embodiments as jembodiments
    import nvblox_mindmap_tpu.geometry as jgeometry

    assert tgeometry.__all__ == jgeometry.__all__
    assert tembodiments.__all__ == jembodiments.__all__
    for package in (tgeometry, tembodiments):
        assert all(callable(getattr(package, name)) for name in package.__all__)


# ------------------------------------------------ positional, data types


def test_rotary_pe_1d_matches_jax():
    rng = np.random.default_rng(0)
    positions = rng.uniform(-20, 20, size=(2, 7)).astype(np.float32)
    out = rotary_pe_1d(torch.from_numpy(positions), 24)
    assert out.shape == (2, 7, 24, 2)
    _close(out, jax_rotary_1d(jnp.asarray(positions), 24))


def test_includes_nvblox_matches_jax():
    for data_type in jtypes.DataType:
        assert (ttypes.includes_nvblox(ttypes.DataType(data_type.value))
                == jtypes.includes_nvblox(data_type))


# ------------------------------------------------------------------ timers


class _FakeClock:
    """``time.perf_counter`` returning scripted instants."""

    def __init__(self, instants):
        self._instants = iter(instants)

    def perf_counter(self):
        return next(self._instants)


DURATIONS = {"step/train/compute": (0.5, 0.25, 1.0), "step/val": (2.0,)}


@pytest.fixture
def recorded_timers(monkeypatch):
    """The same durations recorded through each package's ``Timer``."""
    jtimers.reset_timers()
    ttimers.reset_timers()
    for module in (jtimers, ttimers):
        instants = []
        for durations in DURATIONS.values():
            for d in durations:
                instants += [0.0, 0.0, d]  # __init__, __enter__, stop
        monkeypatch.setattr(module, "time", _FakeClock(instants))
        for name, durations in DURATIONS.items():
            for _ in durations:
                with module.Timer(name):
                    pass
    yield
    jtimers.reset_timers()
    ttimers.reset_timers()


def test_timers_match_jax(recorded_timers, capsys):
    for name in list(DURATIONS) + ["never/recorded"]:
        for getter in ("get_last_time", "get_mean_time", "get_total_time"):
            assert getattr(ttimers, getter)(name) == getattr(jtimers, getter)(name), getter
    assert ttimers.get_mean_time("step/train/compute") == pytest.approx(1.75 / 3)
    assert ttimers.timer_status_string() == jtimers.timer_status_string()
    ttimers.print_timers()
    ours = capsys.readouterr().out
    jtimers.print_timers()
    assert ours == capsys.readouterr().out
    assert ours.splitlines()[0] == "timer name\tcount\ttotal(s)\tmean(s)\tlast(s)\tmax(s)"


def test_log_timings_matches_jax(recorded_timers):
    logged = {}
    for name, module in (("jax", jlogging), ("port", tlogging)):
        logger = module.MetricLogger()
        logger.log = lambda metrics, step, prefix="", name=name: logged.setdefault(
            name, (metrics, step))
        logger.log_timings(7, list(DURATIONS))
    assert logged["port"] == logged["jax"]
    assert set(logged["port"][0]) == {f"timings/{n}" for n in DURATIONS}


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    a = torch.randn(16, 16)
    with ttimers.ProfilerTrace(log_dir) as trace:
        (a @ a).sum()
    assert os.path.dirname(trace.path) == log_dir
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


# ------------------------------------------------------ chunked msgpack


def _chunked_tree(rng):
    return {
        "b": {"w": rng.normal(size=(7, 5)).astype(np.float32), "s": np.float32(2.0),
              "long": rng.normal(size=(13, 17)).astype(np.float32)},  # 56 chunks
        "a": rng.integers(0, 9, (40,)).astype(np.int64),
        "in_a_list": [np.arange(30, dtype=np.float32)],  # flax writes it whole
        "small": np.arange(3, dtype=np.float32),
        "n": 1.5,
    }


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _assert_trees_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages chunk arrays over 16 bytes."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 16)


def test_msgpack_serialize_writes_flax_chunked_bytes(small_chunks):
    rng = np.random.default_rng(0)
    for tree in (_chunked_tree(rng), rng.normal(size=(50,)).astype(np.float32)):
        ours = tckpt.msgpack_serialize(tree)
        theirs = flax.serialization.msgpack_serialize(tree)
        assert ours == theirs
        assert b"__msgpack_chunked_array__" in ours
        _assert_trees_equal(flax.serialization.msgpack_restore(ours), tree)
        _assert_trees_equal(tckpt.msgpack_restore(theirs), tree)


def test_each_package_reads_the_others_chunked_file(small_chunks, tmp_path):
    rng = np.random.default_rng(1)
    params = {"encoder": {"dense": {"kernel": rng.normal(size=(9, 6)).astype(np.float32),
                                    "bias": rng.normal(size=(6,)).astype(np.float32)}}}
    ckpt = str(tmp_path / "jax.ckpt")
    jax_save(ckpt, params, None, 3, 0.5)
    restored, step, loss = tckpt.read_jax_checkpoint(ckpt)
    assert (step, loss) == (3, 0.5)
    _assert_trees_equal(restored, params)
    ours, theirs = str(tmp_path / "ours.msgpack"), str(tmp_path / "theirs.msgpack")
    ttools.main(["extract", ckpt, "encoder/dense", ours])
    jtools.main(["extract", ckpt, "encoder/dense", theirs])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read() and b"__msgpack_chunked_array__" in data
    _assert_trees_equal(jtools.load_subtree(ours), params["encoder"]["dense"])
    _assert_trees_equal(ttools.load_subtree(theirs), params["encoder"]["dense"])


# ------------------------------------------------------- the bench table

# The two JSON layouts of tests/test_scripts.py's renderer test: before the
# flagship train number, and with it and the batch-scaling sweep.
OLD_LAYOUT = {"value": 71.7, "vs_baseline": 1.4, "train_step_ms_b32": 139.9,
              "train_samples_per_s": 228.8}
NEW_LAYOUT = {"value": 70.0, "vs_baseline": 1.43,
              "train_step_ms_b32_flagship": 250.0, "train_samples_per_s": 128.0,
              "train_step_tflops_per_s": 12.0,
              "train_mfu_pct_vs_v5e_bf16_peak": 6.1,
              "train_step_ms_b32_mesh": 140.0,
              "train_batch_scaling": {"64": {"step_ms": 400.0,
                                             "samples_per_s": 160.0}}}


def test_bench_table_renders_as_jax_renders():
    with open(tbench.BENCH_JSON) as f:
        committed = json.load(f)
    for d in (committed, OLD_LAYOUT, NEW_LAYOUT):
        assert tbench.render(d) == jbench.render(d)
        assert tbench.render_readme(d) == jbench.render_readme(d)
    assert (tbench.BEGIN, tbench.END) == (jbench.BEGIN, jbench.END)
    assert (tbench.BENCH_JSON, tbench.DOCS_MD, tbench.README_MD) == (
        jbench.BENCH_JSON, jbench.DOCS_MD, jbench.README_MD)
    assert tbench.main(["--check"]) == 0


def test_bench_table_rewrites_as_jax_rewrites(tmp_path, capsys):
    """Stale tables in copies of the docs: each package's renderer rewrites
    its own copies, and the files come out the same (``--check`` then 0)."""
    files = {}
    for name, module in (("port", tbench), ("jax", jbench)):
        root = tmp_path / name
        root.mkdir()
        paths = {}
        for flag, source in (("--docs_md", tbench.DOCS_MD), ("--readme_md", tbench.README_MD)):
            with open(source) as f:
                stale = tbench.apply(f.read(), "stale")
            paths[flag] = str(root / os.path.basename(source))
            with open(paths[flag], "w") as f:
                f.write(stale)
        shutil.copy(tbench.BENCH_JSON, root / "bench.json")
        argv = ["--bench_json", str(root / "bench.json")]
        argv += [arg for flag, path in paths.items() for arg in (flag, path)]
        assert module.main(argv + ["--check"]) == 1
        assert module.main(argv) == 0
        assert module.main(argv + ["--check"]) == 0
        files[name] = {}
        for flag, path in paths.items():
            with open(path) as f:
                files[name][flag] = f.read()
    assert files["port"] == files["jax"]
    with open(tbench.DOCS_MD) as f:
        assert files["port"]["--docs_md"] == f.read()
    with pytest.raises(ValueError, match="end marker"):
        tbench.apply(tbench.END + tbench.BEGIN, "table")
