"""Torch port vs the JAX package: the language layers and models.

- ``ParallelAttentionLayer`` / ``ParallelAttention`` in the configurations
  the model builds (vision -> language with a feed-forward, trajectory ->
  language without) and with self-attention, masks and semantic positions;
- ``FFWRelativeSelfCrossAttentionModule`` with a context (with and without
  its rotary positions, a key mask on the cross layers) and without one
  (then it has no cross layers, in flax as here);
- a small mesh model with ``use_instruction``, ``lang_enhanced`` and both:
  encode, and a DDIM sampler with the JAX sampler's noise injected, under
  the eager impl and the flash impl (the JAX package's Pallas kernel in
  interpret mode; the port's kernels' plain version on the CPU), with the
  flash calls counted by kernel.

Weights are the JAX modules' flax init through the port's bridge (strict:
a parameter tree that differs raises); inputs and the (B, 53, 512)
instruction (53: 3D Diffuser Actor's padded CLIP-text length) come from
numpy seeds.

Tolerances: layer outputs and encoder features atol 1e-5 (fp32, different
summation orders); trajectories atol 1e-4, as
``tests/test_torch_model_parity.py`` holds them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.models import layers as jlayers
from nvblox_mindmap_tpu.ops import attention as jattention
from nvblox_mindmap_tpu.ops.positional import rotary_pe_3d as jrotary
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models import layers as tlayers
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings,
    convert_diffusion_scheduler,
    convert_to_flash_attention,
)
from nvblox_mindmap_torch.models.weights import load_flax_params
from nvblox_mindmap_torch.ops import flash_attention as fa
from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
from tests import test_torch_model_parity as model_parity
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    BOUNDS,
    FEATURE_ATOL,
    SMALL,
    SMALL_FEATURES,
    TRAJ_ATOL,
    configs,
    make_batch,
    one_torch_thread,
    run_both,
)

E, H = 24, 4
INSTRUCTION_TOKENS = 53


@pytest.fixture(autouse=True)
def restore_impl():
    yield
    set_default_attention_impl("eager")


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ layers


PARALLEL = {
    "vision_language": dict(num_layers=2, self_attention1=False, cross_attention1=True,
                            apply_ffn=True),
    "trajectory_language": dict(num_layers=1, self_attention1=False, cross_attention1=True,
                                apply_ffn=False),
    "self_and_cross_masked": dict(num_layers=2, self_attention1=True, cross_attention1=True,
                                  apply_ffn=True),
}


@pytest.mark.parametrize("case", sorted(PARALLEL))
def test_parallel_attention_matches_jax(case):
    fields = PARALLEL[case]
    seq1, seq2, pos1, pos2 = arrays(0, (2, 12, E), (2, 7, E), (2, 12, E), (2, 7, E))
    masked = case.endswith("masked")
    rng = np.random.default_rng(1)
    mask1 = rng.uniform(size=(2, 12)) < 0.3 if masked else None
    mask2 = rng.uniform(size=(2, 7)) < 0.3 if masked else None
    sem1, sem2 = (pos1, pos2) if masked else (pos1, None)
    jmodule = jlayers.ParallelAttention(d_model=E, n_heads=H, **fields)
    args = (seq1, seq2, mask1, mask2, sem1, sem2)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = jax.jit(jmodule.init)(jax.random.PRNGKey(2), *jargs)["params"]
    ref = jmodule.apply({"params": params}, *jargs)
    module = tlayers.ParallelAttention(fields["num_layers"], E, H, **{
        k: v for k, v in fields.items() if k != "num_layers"})
    load_flax_params(module, params)
    with torch.no_grad():
        out = module(*[t(a) for a in args])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FEATURE_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["context", "context_with_positions", "no_context"])
def test_self_cross_module_matches_jax(case):
    """4 self layers with 3 cross layers at linspace(0, 4, 4) = 0, 1, 2 (4
    is past the end), AdaLN on both; the self layers attend unmasked."""
    query, context, diff_ts = arrays(3, (2, 12, E), (2, 9, E), (2, E))
    xyz_q, xyz_c = arrays(4, (2, 12, 3), (2, 9, 3))
    query_pos = jrotary(jnp.asarray(xyz_q), E)
    context_pos = jrotary(jnp.asarray(xyz_c), E) if case == "context_with_positions" else None
    mask = np.random.default_rng(5).uniform(size=(2, 9)) < 0.3
    with_context = case != "no_context"
    ctx = context if with_context else None
    jmodule = jlayers.FFWRelativeSelfCrossAttentionModule(E, H, 4, 3, use_adaln=True)
    jargs = (jnp.asarray(query), None if ctx is None else jnp.asarray(ctx),
             jnp.asarray(diff_ts), query_pos, context_pos, jnp.asarray(mask))
    params = jax.jit(jmodule.init)(jax.random.PRNGKey(6), *jargs)["params"]
    assert sorted(k for k in params if k.startswith("cross")) == (
        ["cross_0", "cross_1", "cross_2"] if with_context else [])
    ref = jmodule.apply({"params": params}, *jargs)
    module = tlayers.FFWRelativeSelfCrossAttentionModule(E, H, 4, 3, use_adaln=True,
                                                         with_context=with_context)
    load_flax_params(module, params)
    with torch.no_grad():
        out = module(t(query), t(ctx), t(diff_ts), t(query_pos), t(context_pos), t(mask))
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=FEATURE_ATOL, rtol=0)
    if not with_context:
        with pytest.raises(ValueError, match="without a context"):
            module(t(query), t(context))


# ------------------------------------------------------------------ the model


FLAGS = {
    "instruction": dict(use_instruction=True),
    "lang_enhanced": dict(lang_enhanced=True),
    "both": dict(use_instruction=True, lang_enhanced=True),
}
STEPS = 3


@pytest.fixture(scope="module")
def language_models():
    """Per flag set: (JAX config, torch config, batch with an instruction,
    flax params)."""
    out = {}
    for name, flags in FLAGS.items():
        jcfg, tcfg = configs(SMALL_FEATURES, **dict(SMALL, **flags))
        rng = np.random.default_rng(7)
        batch = make_batch(rng, 2, 2, 40, SMALL_FEATURES, BOUNDS, n_invalid=8)
        batch["instruction"] = rng.normal(
            size=(2, INSTRUCTION_TOKENS, 512)).astype(np.float32)
        jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                   jnp.asarray(BOUNDS), jcfg)
        variables = jax.jit(jda.DiffuserActor(jcfg).init)(
            jax.random.PRNGKey(8), jprep, jnp.zeros((2, 1, 2, 9)), jnp.zeros((2,), jnp.int32))
        out[name] = (jcfg, tcfg, batch, jax.tree_util.tree_map(np.asarray, variables["params"]))
    return out


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_language_encode_matches_jax(language_models, name):
    """The parameter trees match (strict bridge: only what flax created:
    no ``cross_*`` without an instruction, no ``traj_lang_attention`` or
    ``vl_attention`` without ``use_instruction``), and encode's outputs,
    the instruction's features included, match."""
    jcfg, tcfg, batch, params = language_models[name]
    assert ("instruction_encoder" in params["encoder"]) == tcfg.use_instruction
    assert ("cross_0" in params["head"]["self_attn"]) == (tcfg.use_instruction
                                                          and tcfg.lang_enhanced)
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(BOUNDS), jcfg)
    ref = jax.jit(lambda v, p: jmodel.apply(
        v, None, None, None, p["vertex_features"], p["vertices"], p["vertices_valid_mask"],
        p["instruction"], p["gripper_history"], p["curr_closedness"],
        method=jda.DiffuserActor.encode))({"params": params}, jprep)
    model = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        out = model.encode_prepared(tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu"))
    assert (out["instr_feats"] is None) == (ref["instr_feats"] is None)
    for key in ("context_feats", "adaln_gripper_feats", "fps_feats", "instr_feats"):
        if ref[key] is not None:
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                       atol=FEATURE_ATOL, rtol=0, err_msg=key)


def expected_launches(cfg, steps):
    """Flash calls by kernel for one prediction, from the model's structure:
    the gripper-history cross-attention (3 layers, nhist * G = 6 queries),
    per step the denoiser's cross-attention (2 layers, L * G = 2 queries),
    the trajectory -> language layer (2 queries) and the self-attention
    stacks (4 + 2 + 2 layers, 2 + 10 FPS tokens), with 3 + 1 + 1
    interleaved cross layers to the instruction; vl_attention (2 layers over
    the 40 context tokens) once."""
    instruction = cfg.use_instruction
    cross_to_language = 5 if cfg.lang_enhanced and instruction else 0
    split = 3 + steps * (2 + instruction)
    tile = 2 * instruction + steps * (8 + cross_to_language)
    return {"flash_attention_split": split, "flash_attention_tile": tile}


@pytest.mark.parametrize("impl", ["eager", "flash"])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_language_sampler_matches_jax(language_models, monkeypatch, name, impl):
    """DDIM-3 with injected noise, eager and flash; under flash every
    attention call of the path goes through the flash op, split and tile
    kernels as ``expected_launches`` derives them."""
    jcfg, tcfg, batch, params = language_models[name]
    calls = {k: 0 for k in fa.KERNELS}
    real = fa.flash_attention

    def counted(q, *args, **kwargs):
        calls[fa.kernel_for(q.shape[2])] += 1
        return real(q, *args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", counted)
    # The JAX attention impl is fixed when a sampler is traced: trace anew.
    monkeypatch.setattr(model_parity, "_JAX_SAMPLERS", {})
    sampler = convert_diffusion_scheduler(STEPS)
    before = jattention.get_default_attention_impl()
    if impl == "flash":
        jattention.set_default_attention_impl("flash")
        assert apply_inference_settings(convert_to_flash_attention()) == {}
    try:
        out, ref = run_both(jcfg, tcfg, params, batch, BOUNDS, seed=9, **sampler)
    finally:
        jattention.set_default_attention_impl(before)
    assert out[0].shape == (2, 1, 2, 8)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=TRAJ_ATOL, rtol=0)
    want = expected_launches(tcfg, STEPS) if impl == "flash" else {k: 0 for k in fa.KERNELS}
    assert calls == want


def test_language_needs_an_instruction():
    _, tcfg = configs(SMALL_FEATURES, **dict(SMALL, use_instruction=True))
    model = tda.DiffuserActor(tcfg, device="cpu")
    batch = make_batch(np.random.default_rng(0), 1, 2, 16, SMALL_FEATURES, BOUNDS)
    with pytest.raises(ValueError, match="instruction"):
        model.encode_prepared(tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu"))
