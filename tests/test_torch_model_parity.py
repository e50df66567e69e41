"""Torch port vs the JAX package: the mesh keypose path on a small model.

Weights are the JAX model's flax init, converted by the port's weight bridge
(``nvblox_mindmap_torch.models.weights``). Inputs come from numpy seeds. The
sampler noise is the JAX sampler's own: ``jax_sampler_noise`` repeats the key
splits of ``sample_trajectory`` (``nvblox_mindmap_tpu/models/diffuser_actor.py``,
the ``all_keys`` / ``pk, rk`` splits) and hands the draws to the port.

Tolerances: encoder and denoiser outputs atol 1e-5 (fp32, different
summation orders in matmuls and softmax over <= 65 keys). Trajectories atol
1e-4 on the unnormalized output: the same differences carried through up to
100 chained sampler steps; the acceptance bound for the port is 1e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.models.feature_extractors import FeatureExtractorType
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings,
    convert_diffusion_scheduler,
    convert_to_flash_attention,
)
from nvblox_mindmap_torch.models.weights import load_flax_params
from nvblox_mindmap_torch.ops import flash_attention as fa
from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

FEATURE_ATOL = 1e-5
TRAJ_ATOL = 1e-4
BOUNDS = np.asarray([[-0.5, -1.0, 0.0], [1.5, 1.0, 2.0]], dtype=np.float32)


# ------------------------------------------------------------------ helpers
# (also used by tests/test_torch_fixture_parity.py)


def configs(vertex_feature_dim, **fields):
    """Matching (JAX, torch) configs for a mesh-only model."""
    jcfg = jda.DiffuserActorConfig(data_type="mesh", feature_type=FeatureExtractorType.RGB,
                                   **fields)
    tcfg = tda.DiffuserActorConfig(data_type="mesh", vertex_feature_dim=vertex_feature_dim,
                                   **fields)
    return jcfg, tcfg


def make_batch(rng, B, G, n_vertices, feature_dim, bounds, n_invalid=0):
    lo, hi = bounds
    pos = rng.uniform(lo, hi, size=(B, 3, G, 3))
    quat = rng.normal(size=(B, 3, G, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    closed = rng.integers(0, 2, size=(B, 3, G, 1))
    mask = np.ones((B, n_vertices), bool)
    mask[:, n_vertices - n_invalid:] = False
    return {
        "gripper_history": np.concatenate([pos, quat, closed], -1).astype(np.float32),
        "vertices": rng.uniform(lo, hi, size=(B, n_vertices, 3)).astype(np.float32),
        "vertex_features": rng.uniform(0, 1, size=(B, n_vertices, feature_dim)).astype(np.float32),
        "vertices_valid_mask": mask,
    }


def jax_sampler_noise(key, num_steps, shape):
    """The JAX sampler's draws: init (B, L, G, 9) and per-step (T, B, L, G, 9)."""
    all_keys = jax.random.split(key, num_steps + 1)
    init = jax.random.normal(all_keys[0], shape + (9,), dtype=jnp.float32)
    pos_rot = jax.vmap(jax.random.split)(all_keys[1:])
    pos = jax.vmap(lambda k: jax.random.normal(k, shape + (3,), dtype=jnp.float32))(pos_rot[:, 0])
    rot = jax.vmap(lambda k: jax.random.normal(k, shape + (6,), dtype=jnp.float32))(pos_rot[:, 1])
    return (torch.from_numpy(np.array(init)),
            torch.from_numpy(np.concatenate([np.asarray(pos), np.asarray(rot)], -1)))


_JAX_SAMPLERS = {}


def jax_sample(model, params, prepared, key, bounds, **kw):
    cache_key = (model.config, tuple(sorted(kw.items())))
    fn = _JAX_SAMPLERS.get(cache_key)
    if fn is None:
        fn = jax.jit(lambda v, p, r, b: jda.sample_trajectory(model, v, p, r, b, **kw))
        _JAX_SAMPLERS[cache_key] = fn
    return fn({"params": params}, prepared, key, bounds)


def run_both(jcfg, tcfg, params, batch, bounds, seed, **sampler):
    """Sample with JAX (its own key) and the port (the same draws injected)."""
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(bounds), jcfg)
    key = jax.random.PRNGKey(seed)
    ref = jax_sample(jmodel, params, jprep, key, jnp.asarray(bounds), **sampler)

    tmodel = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(tmodel, params)
    tprep = tda.prepare_inputs(batch, bounds, tcfg, device="cpu")
    T = len(tcfg.schedules()[0].timesteps(sampler.get("num_inference_steps"),
                                          sampler.get("timestep_spacing", "leading")))
    B = batch["gripper_history"].shape[0]
    init, steps = jax_sampler_noise(key, T, (B, tcfg.prediction_horizon, tcfg.ngrippers))
    out = tda.sample_trajectory(tmodel, tprep, bounds, init_noise=init, step_noise=steps,
                                **sampler)
    return out, ref


def assert_outputs_close(out, ref, atol):
    traj, yaw, weights = out
    rtraj, ryaw, rweights = ref
    np.testing.assert_allclose(traj.numpy(), np.asarray(rtraj), atol=atol, rtol=0)
    assert (yaw is None) == (ryaw is None)
    if yaw is not None:
        np.testing.assert_allclose(yaw.numpy(), np.asarray(ryaw), atol=atol, rtol=0)
    assert (weights is None) == (rweights is None)
    if weights is not None:
        np.testing.assert_allclose(weights.numpy(), np.asarray(rweights), atol=FEATURE_ATOL)


# ------------------------------------------------------------------ small model

SMALL = dict(embedding_dim=24, num_attn_heads=4, diffusion_timesteps=100,
             fps_subsampling_factor=4, ngrippers=2, predict_head_yaw=True)
SMALL_FEATURES = 8


@pytest.fixture(autouse=True)
def restore_impl():
    yield
    set_default_attention_impl("eager")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU sampling is thousands of tiny ops: one intra-op thread
    is fastest, and keeps parallel test workers from oversubscribing cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = configs(SMALL_FEATURES, **SMALL)
    rng = np.random.default_rng(0)
    batch = make_batch(rng, 2, 2, 64, SMALL_FEATURES, BOUNDS, n_invalid=20)
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(BOUNDS), jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jprep,
                                     jnp.zeros((2, 1, 2, 9)), jnp.zeros((2,), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(tmodel, params)
    tprep = tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, jmodel=jmodel, jprep=jprep,
                params=params, tmodel=tmodel, tprep=tprep)


def _jax_encode(s):
    fn = jax.jit(lambda v, p: s["jmodel"].apply(
        v, None, None, None, p["vertex_features"], p["vertices"],
        p["vertices_valid_mask"], None, p["gripper_history"], p["curr_closedness"],
        method=jda.DiffuserActor.encode))
    return fn({"params": s["params"]}, s["jprep"])


def test_prepare_inputs_matches_jax_relative_with_gt():
    jcfg, tcfg = configs(SMALL_FEATURES, **dict(SMALL, relative=True))
    rng = np.random.default_rng(3)
    batch = make_batch(rng, 2, 2, 16, SMALL_FEATURES, BOUNDS)
    gt = make_batch(rng, 2, 2, 1, 1, BOUNDS)["gripper_history"][:, :1]
    batch["gt_gripper_pred"] = gt
    ref = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.asarray(BOUNDS), jcfg)
    out = tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu")
    for name in ("gripper_history", "curr_closedness", "current_pose", "vertices",
                 "vertex_features", "gt_gripper_pred", "gt_openness"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), atol=2e-6,
                                   err_msg=name)


def test_encode_matches_jax(small):
    ref = _jax_encode(small)
    with torch.no_grad():
        out = small["tmodel"].encode_prepared(small["tprep"])
    np.testing.assert_array_equal(out["fps_mask"].numpy(), np.asarray(ref["fps_mask"]))
    assert not out["fps_mask"].all()  # invalid vertices were sampled
    for name in ("context_feats", "context", "adaln_gripper_feats", "fps_feats",
                 "fps_pos", "gripper_attn_weights"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   atol=FEATURE_ATOL, err_msg=name)


def test_denoise_matches_jax(small):
    ref_fixed = _jax_encode(small)
    rng = np.random.default_rng(4)
    traj = rng.normal(size=(2, 1, 2, 9)).astype(np.float32)
    t = np.asarray([3, 71], np.int32)
    ref = jax.jit(lambda v, x, ts, f: small["jmodel"].apply(
        v, x, ts, f, method=jda.DiffuserActor.denoise))(
        {"params": small["params"]}, jnp.asarray(traj), jnp.asarray(t), ref_fixed)
    fixed = {k: None if v is None else torch.from_numpy(np.array(v))
             for k, v in ref_fixed.items()}
    with torch.no_grad():
        out = small["tmodel"].denoise(torch.from_numpy(traj), torch.from_numpy(t), fixed)
    assert_outputs_close(out, ref, FEATURE_ATOL)


SAMPLERS = {
    "ddpm100": dict(num_inference_steps=100, scheduler_kind="ddpm", stochastic=True),
    "ddim10_leading": convert_diffusion_scheduler(10),
    # The trailing case also runs the model in relative mode.
    "ddim10_trailing_relative": dict(convert_diffusion_scheduler(10),
                                     timestep_spacing="trailing"),
    "ddpm20": dict(num_inference_steps=20, scheduler_kind="ddpm", stochastic=True),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sample_trajectory_matches_jax(small, name):
    fields = dict(SMALL, relative=name.endswith("relative"))
    jcfg, tcfg = configs(SMALL_FEATURES, **fields)
    out, ref = run_both(jcfg, tcfg, small["params"], small["batch"], BOUNDS, seed=11,
                        **SAMPLERS[name])
    assert out[0].shape == (2, 1, 2, 8)
    assert_outputs_close(out, ref, TRAJ_ATOL)


def test_sample_trajectory_with_generator_runs():
    _, tcfg = configs(SMALL_FEATURES, **dict(SMALL, diffusion_timesteps=5))
    torch.manual_seed(0)
    model = tda.DiffuserActor(tcfg, device="cpu")
    batch = make_batch(np.random.default_rng(5), 1, 2, 16, SMALL_FEATURES, BOUNDS)
    prep = tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu")
    draws = [tda.sample_trajectory(model, prep, BOUNDS,
                                   generator=torch.Generator().manual_seed(7))[0]
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    assert torch.isfinite(draws[0]).all()
    with pytest.raises(ValueError, match="Generator"):
        tda.sample_trajectory(model, prep, BOUNDS)


def test_flash_path_matches_jax_xla(monkeypatch):
    """The flash swap at the JAX package's swap-test config: the port's flash
    path (the kernel's plain version on the CPU) vs JAX's XLA path. Every row
    has a valid key here, so the two impls compute the same function."""
    fields = dict(embedding_dim=24, num_attn_heads=4, diffusion_timesteps=3,
                  fps_subsampling_factor=4)
    jcfg, tcfg = configs(8, **fields)
    rng = np.random.default_rng(0)
    batch = make_batch(rng, 2, 1, 32, 8, BOUNDS)
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(BOUNDS), jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jprep,
                                     jnp.zeros((2, 1, 1, 9)), jnp.zeros((2,), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert apply_inference_settings(convert_to_flash_attention()) == {}
    out, ref = run_both(jcfg, tcfg, params, batch, BOUNDS, seed=0)
    assert len(calls) == 3 + 10 * 3  # every attention call of the path
    assert out[2] is None and ref[2] is not None
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=TRAJ_ATOL, rtol=0)


def test_flash_model_at_head_dim_144_matches_jax_flash():
    """Head dims above 128 (2 heads of 144): the port's flash model vs the
    JAX model with its Pallas kernel in interpret mode, which pads D to 256."""
    from nvblox_mindmap_tpu.ops import attention as jattention

    jcfg, tcfg = configs(8, embedding_dim=288, num_attn_heads=2, diffusion_timesteps=3,
                         fps_subsampling_factor=4)
    rng = np.random.default_rng(1)
    batch = make_batch(rng, 1, 1, 16, 8, BOUNDS, n_invalid=4)
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(BOUNDS), jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jprep,
                                     jnp.zeros((1, 1, 1, 9)), jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    before = jattention.get_default_attention_impl()
    jattention.set_default_attention_impl("flash")
    try:
        assert apply_inference_settings(convert_to_flash_attention()) == {}
        out, ref = run_both(jcfg, tcfg, params, batch, BOUNDS, seed=3)
    finally:
        jattention.set_default_attention_impl(before)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=TRAJ_ATOL, rtol=0)


def test_bridge_is_strict(small):
    model = tda.DiffuserActor(small["tcfg"], device="cpu")
    params = small["params"]
    missing = dict(params, encoder={k: v for k, v in params["encoder"].items()
                                    if k != "goal_gripper_embed"})
    with pytest.raises(KeyError, match="goal_gripper_embed"):
        load_flax_params(model, missing)
    extra = dict(params, head=dict(params["head"], extra_dense={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="extra_dense"):
        load_flax_params(model, extra)
    wrong = dict(params, head=dict(params["head"],
                                   traj_encoder={"kernel": np.zeros((9, 5)),
                                                 "bias": np.zeros(5)}))
    with pytest.raises(ValueError, match="traj_encoder"):
        load_flax_params(model, wrong)


def test_unported_paths_raise():
    """The CLIP and language configs the port used to refuse now build (the
    CLIP trunk frozen, its FPN trainable; the language modules present);
    their parity is in ``tests/test_torch_clip.py`` and
    ``tests/test_torch_language.py``. A shared feature encoder without
    image inputs still raises."""
    cfg = tda.DiffuserActorConfig(data_type="rgbd_and_mesh", feature_type="clip_resnet50_fpn",
                                  feature_image_size=(4, 4), embedding_dim=24,
                                  num_attn_heads=4)
    model = tda.DiffuserActor(cfg, device="cpu")
    extractor = model.encoder.feature_extractor
    assert not any(p.requires_grad for p in extractor.backbone.parameters())
    assert all(p.requires_grad for p in extractor.fpn.parameters())
    cfg = tda.DiffuserActorConfig(use_instruction=True, lang_enhanced=True, embedding_dim=24,
                                  num_attn_heads=4)
    model = tda.DiffuserActor(cfg, device="cpu")
    assert hasattr(model.encoder, "vl_attention") and hasattr(model.head, "traj_lang_attention")
    assert sorted(model.head.self_attn.cross_inds) == [0, 1, 2]
    with pytest.raises(ValueError, match="image inputs"):
        tda.DiffuserActorConfig(data_type="mesh", use_shared_feature_encoder=True)
