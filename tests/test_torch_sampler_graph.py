"""``sample_trajectory``'s CUDA graph path, the parts a CPU can hold: when the
graph path applies, that the key of a captured loop names every input it
bakes in, that on the CPU the loop stays eager and is counted so, and how
the flash counters take a replay's launches. The replays themselves, bit for
bit against the eager loop, are card tests (``tests/test_torch_cuda.py``).
"""
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from nvblox_mindmap_torch.models import diffuser_actor as da
from nvblox_mindmap_torch.ops import flash_attention as fa
from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

BOUNDS = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
SAMPLER = dict(num_inference_steps=3, scheduler_kind="ddim", stochastic=False)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return da.DiffuserActor(da.DiffuserActorConfig(embedding_dim=24, num_attn_heads=4,
                                                   vertex_feature_dim=3,
                                                   fps_subsampling_factor=4),
                            device="cpu")


def _prepared(model, B=1, vertices=32, seed=0):
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(B, 3, 1, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    batch = {
        "gripper_history": np.concatenate(
            [rng.uniform(0, 1, (B, 3, 1, 3)), quat, np.ones((B, 3, 1, 1))], -1
        ).astype(np.float32),
        "vertices": rng.uniform(0, 1, (B, vertices, 3)).astype(np.float32),
        "vertex_features": rng.uniform(0, 1, (B, vertices, 3)).astype(np.float32),
    }
    return da.prepare_inputs(batch, BOUNDS, model.config, device="cpu")


def _path_counts():
    return {c: getattr(da.sample_trajectory, c)
            for c in ("graph_captures", "graph_replays", "eager_calls")}


@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_sampler_stays_eager_on_cpu(model, impl):
    """On the CPU no graph is captured, under either attention impl: each
    call counts one eager call, and the same inputs give the same bits."""
    prepared = _prepared(model)
    init = torch.randn((1, 1, 1, 9), generator=torch.Generator().manual_seed(1))
    try:
        set_default_attention_impl(impl)
        before = _path_counts()
        a = da.sample_trajectory(model, prepared, BOUNDS, init_noise=init, **SAMPLER)
        b = da.sample_trajectory(model, prepared, BOUNDS, init_noise=init, **SAMPLER)
    finally:
        set_default_attention_impl("eager")
    after = _path_counts()
    assert after == dict(before, eager_calls=before["eager_calls"] + 2)
    assert torch.equal(a[0], b[0])
    assert model not in da._GRAPHS


def _stub(is_cuda=True, training=False):
    return types.SimpleNamespace(training=training), types.SimpleNamespace(is_cuda=is_cuda)


@pytest.mark.parametrize("change", [None, "cpu", "grad", "training", "eager_impl",
                                    "dispatch_mode", "capturing"])
def test_graph_applies_only_where_it_may(monkeypatch, change):
    """The graph path applies on CUDA inputs, without autograd, in eval mode,
    under flash attention, with no dispatch mode and no capture under way;
    each condition alone turns it off."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: change == "capturing")
    model, trajectory = _stub(is_cuda=change != "cpu", training=change == "training")
    try:
        set_default_attention_impl("eager" if change == "eager_impl" else "flash")
        with torch.set_grad_enabled(change == "grad"):
            if change == "dispatch_mode":
                with FlopCounterMode(display=False):
                    applies = da._graph_applies(model, trajectory)
            else:
                applies = da._graph_applies(model, trajectory)
    finally:
        set_default_attention_impl("eager")
    assert applies == (change is None)


@pytest.fixture(scope="module")
def key_inputs(model):
    """What ``_graph_key`` reads for a DDIM-3 call of ``model``."""
    with torch.no_grad():
        fixed = model.encode_prepared(_prepared(model))
    sched = model.config.schedules(kind="ddim")[0]
    timesteps = tuple(sched.timesteps(3).tolist())
    return dict(model=model, fixed=fixed, trajectory=torch.zeros(1, 1, 1, 9),
                step_noise=None, timesteps=timesteps, step_ratio=100 // 3, schedule=sched,
                impl="flash")


def _replace_fixed(name, value):
    def change(kw):
        kw["fixed"] = dict(kw["fixed"], **{name: value(kw["fixed"].get(name))})
    return change


KEY_CHANGES = {
    "batch": lambda kw: kw.update(trajectory=torch.zeros(2, 1, 1, 9)),
    "trajectory_dtype": lambda kw: kw.update(trajectory=torch.zeros(1, 1, 1, 9,
                                                                    dtype=torch.float64)),
    "trajectory_device": lambda kw: kw.update(trajectory=torch.zeros(1, 1, 1, 9,
                                                                     device="meta")),
    "step_noise": lambda kw: kw.update(step_noise=torch.zeros(3, 1, 1, 1, 9)),
    "timesteps": lambda kw: kw.update(timesteps=kw["timesteps"][:-1] + (1,)),
    "step_ratio": lambda kw: kw.update(step_ratio=kw["step_ratio"] + 1),
    "scheduler_kind": lambda kw: kw.update(schedule=kw["model"].config.schedules()[0]),
    "clip_sample": lambda kw: kw.update(schedule=_replaced(kw["schedule"], clip_sample=False)),
    "clip_range": lambda kw: kw.update(schedule=_replaced(kw["schedule"], clip_range=2.0)),
    "impl": lambda kw: kw.update(impl="eager"),
    "context_feats_shape": _replace_fixed("context_feats", lambda x: x[:, :-1]),
    "context_shape": _replace_fixed("context", lambda x: x[:, :-1]),
    "context_mask_dtype": _replace_fixed("context_mask", lambda x: x.float()),
    "instr_feats_present": _replace_fixed("instr_feats", lambda x: torch.zeros(1, 4, 24)),
    "adaln_gripper_feats_shape": _replace_fixed("adaln_gripper_feats", lambda x: x[:, :-1]),
    "fps_feats_stride": _replace_fixed("fps_feats",
                                       lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)),
    "fps_pos_device": _replace_fixed("fps_pos", lambda x: x.to("meta")),
    "fps_mask_shape": _replace_fixed("fps_mask", lambda x: x[:, :-1]),
    "new_tensor_entry": _replace_fixed("new_input", lambda x: torch.zeros(1, 24)),
}
FLAG_CHANGES = {
    "matmul_tf32": (torch.backends.cuda.matmul, "allow_tf32", lambda v: not v),
    "cudnn_tf32": (torch.backends.cudnn, "allow_tf32", lambda v: not v),
}


def _replaced(schedule, **fields):
    import dataclasses

    return dataclasses.replace(schedule, **fields)


def test_graph_key_is_stable(key_inputs):
    assert da._graph_key(**key_inputs) == da._graph_key(**dict(key_inputs))


@pytest.mark.parametrize("what", sorted(KEY_CHANGES))
def test_graph_key_names_each_input(key_inputs, what):
    """Each input, step and rule that a captured loop bakes in changes the
    key when it changes."""
    changed = dict(key_inputs)
    KEY_CHANGES[what](changed)
    assert da._graph_key(**changed) != da._graph_key(**key_inputs)


@pytest.mark.parametrize("what", ["float32_matmul_precision", *sorted(FLAG_CHANGES)])
def test_graph_key_names_the_tf32_flags(key_inputs, what):
    base = da._graph_key(**key_inputs)
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        if what == "float32_matmul_precision":
            torch.set_float32_matmul_precision("medium" if saved[0] != "medium" else "highest")
        else:
            module, name, value = FLAG_CHANGES[what]
            setattr(module, name, value(getattr(module, name)))
        assert da._graph_key(**key_inputs) != base
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
    assert da._graph_key(**key_inputs) == base


def test_graph_key_names_the_parameters_storage(key_inputs):
    """New storage for the denoiser's parameters (a moved or rebuilt model)
    changes the key; weights loaded in place do not."""
    model = key_inputs["model"]
    base = da._graph_key(**key_inputs)
    param = next(model.head.parameters())
    saved, values = param.data, param.detach().clone()
    try:
        with torch.no_grad():
            param.add_(1)
        assert da._graph_key(**key_inputs) == base
        param.data = saved.clone()
        assert da._graph_key(**key_inputs) != base
    finally:
        saved.copy_(values)
        param.data = saved
    assert da._graph_key(**key_inputs) == base


def test_graph_key_reads_only_the_tensors_of_the_encoding(key_inputs):
    """A captured loop reads the encoder's tensors: an entry that is None,
    or no tensor, is neither an input nor part of the key."""
    base = da._graph_key(**key_inputs)
    for extra in (None, 3, "flash"):
        changed = dict(key_inputs, fixed=dict(key_inputs["fixed"], other=extra))
        assert da._graph_key(**changed) == base
    assert set(da._tensors(key_inputs["fixed"])) == {
        name for name, x in key_inputs["fixed"].items() if x is not None}


CALLS = (fa.KernelCall("flash_attention_split", (1, 8, 1, 24), 3072, 4, None),
         fa.KernelCall("flash_attention_tile", (1, 8, 615, 24), 615, 4, 600))


@pytest.fixture
def flash_counters():
    """The flash counters, put back as they were after the test."""
    saved = (fa.flash_attention.launches, dict(fa.KERNEL_LAUNCHES), fa.REPLAYED.copy())
    yield
    fa.flash_attention.launches = saved[0]
    fa.KERNEL_LAUNCHES.update(saved[1])
    fa.REPLAYED.clear()
    fa.REPLAYED.update(saved[2])


def test_a_replay_counts_the_calls_it_replays(flash_counters):
    """Each replay adds its capture's calls to the kernel launches, to the
    ``flash_attention`` calls and, by call, to ``REPLAYED``."""
    calls, launches = fa.flash_attention.launches, dict(fa.KERNEL_LAUNCHES)
    replayed = fa.REPLAYED.copy()
    for _ in range(3):
        fa.add_replayed(CALLS + CALLS[1:])
    assert fa.flash_attention.launches == calls + 9
    assert fa.KERNEL_LAUNCHES == {"flash_attention_split": launches["flash_attention_split"] + 3,
                                  "flash_attention_tile": launches["flash_attention_tile"] + 6}
    assert fa.REPLAYED - replayed == {CALLS[0]: 3, CALLS[1]: 6}


def test_listing_launches_is_per_block_and_reads_the_valid_keys():
    """The list holds the block's launches in order, each mask read as its
    valid keys over the batch; an inner block lists its own launches only,
    and a launch on the CPU (the plain version) is none."""
    q = torch.zeros(2, 1, 3, 4)
    mask = torch.tensor([[True, False, True], [True, True, True]])
    with fa.listing_launches() as outer:
        fa.flash_attention(q, q, q, mask)
        fa._LISTING.calls.append(("flash_attention_tile", (2, 1, 3, 4), 3, 4, mask))
        with fa.listing_launches() as inner:
            fa._LISTING.calls.append(("flash_attention_split", (2, 1, 3, 4), 3, 2, None))
        fa._LISTING.calls.append(("flash_attention_tile", (2, 1, 3, 4), 3, 4, ~mask))
    assert inner == [fa.KernelCall("flash_attention_split", (2, 1, 3, 4), 3, 2, None)]
    assert outer == [fa.KernelCall("flash_attention_tile", (2, 1, 3, 4), 3, 4, 5),
                     fa.KernelCall("flash_attention_tile", (2, 1, 3, 4), 3, 4, 1)]
    assert getattr(fa._LISTING, "calls", None) is None
