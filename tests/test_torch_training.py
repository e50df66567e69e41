"""Torch port vs the JAX package: training.

Held against the JAX package: the noising step, the losses and metrics, the
learning-rate schedule, the weight-decay and trainable masks, one train step
(loss and every gradient), AdamW updates with and without accumulation, and
one eval batch. The port's own machinery: the chunked backbone, layer
checkpointing, checkpoints and resume, the JAX checkpoint reader, the flash
kernels' refusal under autograd, and the flax initialisers.

Both packages start from the same flax init, converted by the port's bridge
(``models/weights.py``); batches come from numpy seeds, noise and timesteps
from the JAX key splits. The image model runs the registry RADIO ViT at its
published width and depth 2 (``depth2_backbones``). Its bf16 output differs
between the packages by up to 0.1 (``tests/test_torch_image_path.py`` holds
it there), so the train-step case sets its final LayerNorm's scale to zero:
both backbones then emit that LayerNorm's bias exactly, and the fp32 model
after them is held at fp32 tolerances.

Tolerances:
- ``add_noise`` atol 1e-7; losses and metrics 1e-6 (the same fp32
  formulas in eager ops), and 1e-6 relative besides for the metrics in
  degrees: a mean geodesic error of ~100 degrees has an fp32 ulp of ~8e-6,
  and atan2 differs in it (1.5e-5 measured);
- the learning rate equal (float32 in both);
- one train step: the loss within 1e-5 relative, every trainable gradient
  atol 1e-5 / rtol 1e-4 (fp32 summation orders through forward and
  backward); the backbone gets no gradient;
- AdamW: parameters within 1e-6 after 3 updates and after 2 x 2
  accumulated micro-steps, given the same gradients;
- one eval batch (DDIM-10): loss and every metric within 1e-4 (ten
  chained sampler steps, as the trajectory tests hold);
- the flax initialisers: each parameter's std within 5% of flax's where it
  has >= 10^4 elements (a smaller one's sampling error approaches that);
  zero and one initialisations equal.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.models import encoder as jenc
from nvblox_mindmap_tpu.models import loss as jloss
from nvblox_mindmap_tpu.ops import schedulers as jsched
from nvblox_mindmap_tpu.training import optimizer as jopt
from nvblox_mindmap_tpu.training import trainer as jtrainer
from nvblox_mindmap_tpu.utils import timers as jtimers
from nvblox_mindmap_torch.data.sampler import WeightedEpochSampler
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models import layers as tlayers
from nvblox_mindmap_torch.models import loss as tloss
from nvblox_mindmap_torch.models.weights import flax_to_state_dict
from nvblox_mindmap_torch.ops import flash_attention as fa
from nvblox_mindmap_torch.ops import schedulers as tsched
from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
from nvblox_mindmap_torch.training import checkpoint as tckpt
from nvblox_mindmap_torch.training import optimizer as topt
from nvblox_mindmap_torch.training.trainer import (
    Trainer,
    TrainerConfig,
    make_train_batch_template,
)
from nvblox_mindmap_torch.utils import timers as ttimers
from tests.test_torch_fixture_parity import DATA, fixture_configs, load_params
from tests.test_torch_image_path import (  # noqa: F401 (depth2_backbones: fixture)
    depth2_backbones,
    image_configs,
    init_jax,
    jax_depth2_factory,
    make_image_batch,
    random_vit_params,
)
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    BOUNDS,
    configs,
    jax_sampler_noise,
    make_batch,
    one_torch_thread,
)

SMALL = dict(embedding_dim=24, num_attn_heads=4, diffusion_timesteps=100,
             fps_subsampling_factor=4)
CKPTS = ("spatial_memory/mesh_last.ckpt", "spatial_memory/rgbd_last.ckpt",
         "task_success/cube_stacking/last.ckpt", "task_success/drill_in_box/last.ckpt",
         "task_success/mug_in_drawer/last.ckpt", "task_success/stick_in_bin/last.ckpt")


@pytest.fixture(autouse=True)
def restore_impl():
    yield
    set_default_attention_impl("eager")


def pose8(rng, shape):
    lo, hi = BOUNDS
    quat = rng.normal(size=shape + (4,))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return np.concatenate([rng.uniform(lo, hi, size=shape + (3,)), quat,
                           rng.integers(0, 2, size=shape + (1,))], -1).astype(np.float32)


def mesh_batch(rng, B=2, G=1, head_yaw=False):
    batch = make_batch(rng, B, G, 32, 8, BOUNDS, n_invalid=4)
    batch["gt_gripper_pred"] = pose8(rng, (B, 1, G))
    if head_yaw:
        batch["gt_head_yaw"] = rng.uniform(-np.pi, np.pi, (B, 1, 1)).astype(np.float32)
    return batch


def trainer_for(tcfg, params=None, **fields):
    trainer = Trainer(tcfg, TrainerConfig(**fields), BOUNDS, device="cpu")
    trainer.init_state(flax_params=params)
    return trainer


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_add_noise_matches_jax(schedule):
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(6, 1, 2, 6)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = rng.integers(0, 100, 6)
    ref = jsched.make_schedule(schedule, 100).add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                                        jnp.asarray(t))
    out = tsched.make_schedule(schedule, 100).add_noise(torch.from_numpy(x0),
                                                        torch.from_numpy(noise),
                                                        torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7, rtol=0)


LOSS_CASES = {
    "openness": dict(B=3, L=2, G=2, openness=True, head_yaw=False),
    "no_openness": dict(B=3, L=2, G=2, openness=False, head_yaw=False),
    "head_yaw": dict(B=3, L=2, G=2, openness=True, head_yaw=True),
    "single_sample": dict(B=1, L=1, G=1, openness=True, head_yaw=False),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_metrics_match_jax(case):
    """Every branch: openness on or off, head yaw, and one sample (where the
    std metrics fall back to the population std)."""
    B, L, G, openness, head_yaw = (LOSS_CASES[case][k]
                                   for k in ("B", "L", "G", "openness", "head_yaw"))
    rng = np.random.default_rng(sorted(LOSS_CASES).index(case))
    f32 = np.float32
    pred = rng.normal(size=(B, L, G, 10)).astype(f32)
    target = rng.normal(size=(B, L, G, 9)).astype(f32)
    gt_open = rng.integers(0, 2, (B, L, G, 1)).astype(f32) if openness else None
    yaw_pred = rng.normal(size=(B, L, 1)).astype(f32) if head_yaw else None
    yaw_gt = rng.uniform(-np.pi, np.pi, (B, L, 1)).astype(f32) if head_yaw else None
    weights = tloss.LossWeights(pos_loss=3.0, rot_loss=2.0, gripper_loss=0.5, head_yaw_loss=4.0)
    jweights = jloss.LossWeights(pos_loss=3.0, rot_loss=2.0, gripper_loss=0.5, head_yaw_loss=4.0)

    def jx(x):
        return None if x is None else jnp.asarray(x)

    def tx(x):
        return None if x is None else torch.from_numpy(x)

    ref = jloss.compute_loss(jx(pred), jx(yaw_pred), jx(target), jx(gt_open), jx(yaw_gt),
                             jweights, predict_head_yaw=head_yaw)
    out = tloss.compute_loss(tx(pred), tx(yaw_pred), tx(target), tx(gt_open), tx(yaw_gt),
                             weights, predict_head_yaw=head_yaw)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=0,
                                   err_msg=k)

    def quat_action(n_open):
        q = rng.normal(size=(B, L, G, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        parts = [rng.normal(size=(B, L, G, 3)), q, rng.uniform(size=(B, L, G, n_open))]
        return np.concatenate(parts, -1).astype(f32)

    n_open = 1 if openness else 0
    pred_q, target_q = quat_action(n_open), quat_action(n_open)
    ref = jloss.compute_metrics(jx(pred_q), jx(yaw_pred), jx(target_q), jx(yaw_gt),
                                predict_head_yaw=head_yaw)
    out = tloss.compute_metrics(tx(pred_q), tx(yaw_pred), tx(target_q), tx(yaw_gt),
                                predict_head_yaw=head_yaw)
    assert sorted(out) == sorted(ref)
    assert len(out) == 11 + openness + head_yaw
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    if B == 1:
        assert float(out["distance_m_std"]) == 0.0


def test_lr_schedule_matches_jax():
    for args in ((1e-4, 0.5, 100_000, 0.75), (3e-4, 0.1, 40, 0.5), (1e-3, 2.0, 1, 0.75)):
        ref, out = jopt.linear_lr_schedule(*args), topt.linear_lr_schedule(*args)
        steps = list(range(0, 64)) + [29_999, 74_999, 75_000, 99_999]
        assert [out(s) for s in steps] == [float(ref(jnp.int32(s))) for s in steps], args


@pytest.fixture(scope="module")
def dino():
    """rgbd_and_mesh with a depth-2 DINOv2 ViT-S/14 (LayerScale gammas):
    (torch config, flax params)."""
    jcfg, tcfg = image_configs("rgbd_and_mesh", feature_type="dino_v2_vits14",
                               feature_image_size=(2, 2), vertex_feature_dim=8, **SMALL)
    batch = make_image_batch(np.random.default_rng(1), 2, 2, 28, BOUNDS, n_vertices=16,
                             feature_dim=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, "make_feature_extractor", jax_depth2_factory)
        _, _, params = init_jax(jcfg, batch, BOUNDS)
    return tcfg, params


def test_decay_and_trainable_masks_match_jax(depth2_backbones, dino):
    """The port's masks equal the JAX package's on the flax tree, mapped
    through the bridge: LayerNorm scales (torch's ``weight``) and biases do
    not decay; the backbone does not train."""
    tcfg, params = dino
    model = tda.DiffuserActor(tcfg, device="cpu")
    for port, ref in ((topt.decay_mask(model), jopt._decay_mask(params)),
                      (topt.frozen_feature_extractor_mask(model),
                       jopt.frozen_feature_extractor_mask(params))):
        ref = {k: bool(v.reshape(-1)[0]) for k, v in flax_to_state_dict(ref).items()}
        assert port == ref
    decay = topt.decay_mask(model)
    assert not decay["head.self_attn.attn.0.norm.weight"]
    assert not decay["encoder.feature_extractor.ln_final.weight"]
    assert decay["head.self_attn.attn.0.attention.q_proj.weight"]
    assert decay["encoder.feature_extractor.ls1.0"]


# ------------------------------------------------------------------ one step


def jax_train_step(jcfg, params, batch, seed):
    """The JAX loss and gradients, and the noise and timesteps it drew."""
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(BOUNDS), jcfg)
    key = jax.random.PRNGKey(seed)

    def loss_fn(p):
        losses = jda.diffusion_train_loss(jmodel, {"params": p}, jprep, key)
        return losses["total"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return (losses, jax.tree_util.tree_map(np.asarray, grads)) + jax_step_noise(jcfg, jprep, key)


def jax_step_noise(jcfg, jprep, key):
    """The noise and timesteps ``diffusion_train_loss`` draws from ``key``."""
    noise_key, t_key, _ = jax.random.split(key, 3)
    gt = jprep["gt_gripper_pred"]
    noise = jax.random.normal(noise_key, gt.shape, dtype=gt.dtype)
    timesteps = jax.random.randint(t_key, (gt.shape[0],), 0, jcfg.diffusion_timesteps)
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(timesteps))


def image_train_case(rng):
    jcfg, tcfg = image_configs("rgbd_and_mesh", feature_type="radio_v25_b",
                               feature_image_size=(2, 2), vertex_feature_dim=8, **SMALL)
    batch = make_image_batch(rng, 2, 2, 32, BOUNDS, n_vertices=16, feature_dim=8)
    batch["gt_gripper_pred"] = pose8(rng, (2, 1, 1))
    _, _, params = init_jax(jcfg, batch, BOUNDS)
    vit = random_vit_params(_jax_radio_depth2(), batch["rgbs"][0], seed=9)
    width = vit["ln_final"]["scale"].shape
    vit["ln_final"] = {"scale": np.zeros(width, np.float32),
                       "bias": rng.normal(size=width).astype(np.float32)}
    params["encoder"]["feature_extractor"] = vit
    return jcfg, tcfg, batch, params


def _jax_radio_depth2():
    from nvblox_mindmap_tpu.models import feature_extractors as jfe

    return jfe.make_feature_extractor(jfe.FeatureExtractorType.RADIO_V25_B, (2, 2)).clone(depth=2)


@pytest.fixture(scope="module")
def mesh():
    """A small mesh model with a head-yaw predictor: (JAX config, torch
    config, batch, flax params)."""
    jcfg, tcfg = configs(8, **dict(SMALL, predict_head_yaw=True))
    batch = mesh_batch(np.random.default_rng(2), head_yaw=True)
    _, _, params = init_jax(jcfg, batch, BOUNDS)
    return jcfg, tcfg, batch, params


@pytest.mark.parametrize("data_type", ["mesh", "rgbd_and_mesh"])
def test_train_step_matches_jax(depth2_backbones, mesh, data_type):
    if data_type == "mesh":
        jcfg, tcfg, batch, params = mesh
    else:
        jcfg, tcfg, batch, params = image_train_case(np.random.default_rng(2))
    ref_losses, ref_grads, noise, timesteps = jax_train_step(jcfg, params, batch, seed=3)
    trainer = trainer_for(tcfg, params)
    losses = trainer.compute_loss_and_grads(batch, 0, noise, timesteps)
    assert sorted(losses) == sorted(ref_losses)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(v), rtol=1e-5, atol=0,
                                   err_msg=k)
    ref = flax_to_state_dict(ref_grads)
    no_grad = set()
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:  # the frozen backbone: JAX's stop_gradient gives zeros
            assert "feature_extractor" in name and p.grad is None
            assert not ref[name].any(), name
            continue
        if p.grad is None:
            no_grad.add(name)
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        torch.testing.assert_close(grad, ref[name], atol=1e-5, rtol=1e-4, msg=name)
    # The only trainable parameter the keypose path never reads.
    assert no_grad == {"encoder.goal_gripper_embed"}
    assert (data_type == "mesh") == (not any("feature_extractor" in n for n in ref))


@pytest.mark.parametrize("accumulate,micro_steps", [(1, 3), (2, 4)])
def test_adamw_matches_optax(depth2_backbones, dino, accumulate, micro_steps):
    """The same gradients through optax's AdamW (masked decay, frozen
    backbone, LinearLR, MultiSteps) and the port's optimizer. A large decay
    makes a wrong mask show."""
    tcfg, params = dino
    hyper = dict(initial_learning_rate=1e-3, weight_decay=0.1, train_iters=4)
    tx = jopt.make_optimizer(
        params, initial_learning_rate=1e-3, weight_decay=0.1, end_factor=0.5, total_iters=4,
        accumulate_grad_batches=accumulate,
        trainable_mask=jopt.frozen_feature_extractor_mask(params, fpn_trainable=True))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    trainer = trainer_for(tcfg, params, accumulate_grad_batches=accumulate, **hyper)
    rng = np.random.default_rng(5)
    for _ in range(micro_steps):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 1e-2).astype(np.float32), params)
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = flax_to_state_dict(grads)
        for name, p in trainer.model.named_parameters():
            if p.requires_grad:
                p.grad = grads[name].clone()
        trainer.optimizer.step()
        trainer.optimizer.zero_grad()
    assert trainer.optimizer.count == micro_steps // accumulate
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    for name, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, ref[name], atol=1e-6, rtol=0, msg=name)


def test_eval_batch_matches_jax(mesh):
    """DDIM-10 in normalized space, the loss against the normalized ground
    truth, the metrics on unnormalized quaternions (with head yaw)."""
    jcfg, tcfg, batch, params = mesh
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(batch_size=2), BOUNDS)
    key = jax.random.PRNGKey(7)
    ref_losses, ref_metrics, ref_pred, ref_gt = jt._build_eval_step()(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    trainer = trainer_for(tcfg, params)
    init, _ = jax_sampler_noise(key, 10, (2, 1, 1))
    losses, metrics, pred, gt = trainer.eval_step(batch, init_noise=init)
    for out, ref in ((losses, ref_losses), (metrics, ref_metrics)):
        assert sorted(out) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(out[k].numpy(), np.asarray(v), atol=1e-4, rtol=0,
                                       err_msg=k)
    assert "head_yaw_error_deg" in metrics and len(metrics) == 13
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(ref_gt), atol=1e-6, rtol=0)


# ------------------------------------------------------------------ the port's machinery


def test_chunked_backbone_equals_one_call(depth2_backbones):
    """Chunks of 2 of 6 images give the one call's features; a chunk that
    does not divide the images (4) makes one call, as in JAX."""
    _, tcfg = image_configs("rgbd", feature_type="dino_v2_vits14", feature_image_size=(2, 2),
                            backbone_chunk_images=2, **SMALL)
    model = tda.DiffuserActor(tcfg, device="cpu")
    assert model.encoder.backbone_chunk_images == 2
    prepared = tda.prepare_inputs(make_image_batch(np.random.default_rng(7), 3, 2, 28, BOUNDS),
                                  BOUNDS, tcfg, device="cpu")
    calls = []
    model.encoder.feature_extractor.register_forward_hook(
        lambda module, args, out: calls.append(args[0].shape[0]))

    def encode(chunk):
        model.encoder.backbone_chunk_images = chunk
        calls.clear()
        with torch.no_grad():
            out = model.encoder.encode_images(prepared["rgbs"], prepared["pcds"],
                                              prepared["pcd_valid_mask"])
        return out, list(calls)

    (ref, ref_pos, ref_mask), ref_calls = encode(None)
    assert ref_calls == [6]
    for chunk, expected_calls in ((2, [2, 2, 2]), (3, [3, 3]), (4, [6]), (6, [6])):
        (feats, pos, mask), n = encode(chunk)
        assert n == expected_calls, chunk
        torch.testing.assert_close(feats, ref, rtol=0, atol=1e-6)
        assert torch.equal(pos, ref_pos) and torch.equal(mask, ref_mask)


def test_layer_checkpointing_gives_the_same_loss_and_grads(monkeypatch):
    _, tcfg = configs(8, **SMALL)
    batch = mesh_batch(np.random.default_rng(8))
    calls = []
    real = tlayers.checkpoint
    monkeypatch.setattr(tlayers, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    results = {}
    for policy in ("none", "dots_no_batch"):
        trainer = trainer_for(tcfg, remat_policy=policy)
        losses = trainer.compute_loss_and_grads(batch, 0)
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        results[policy] = (losses, grads, len(calls))
    (loss0, grads0, n0), (loss1, grads1, n1) = results["none"], results["dots_no_batch"]
    assert n0 == 0 and n1 == 3 + 2 + 4 + 2 + 2  # every layer of every stack
    assert float(loss0["total"]) == float(loss1["total"])
    assert sorted(grads0) == sorted(grads1)
    for name in grads0:
        torch.testing.assert_close(grads1[name], grads0[name], rtol=0, atol=1e-7, msg=name)
    with pytest.raises(ValueError, match="remat_policy"):
        Trainer(tcfg, TrainerConfig(remat_policy="dots_everything"), BOUNDS, device="cpu")


def test_checkpoints_round_trip_and_keep_the_running_best(tmp_path):
    _, tcfg = configs(8, **SMALL)
    batch = mesh_batch(np.random.default_rng(9))
    trainer = trainer_for(tcfg, checkpoint_dir=str(tmp_path), accumulate_grad_batches=2)
    for step in range(3):  # one update and one micro-step pending
        trainer.train_one_step(batch, step)
    assert trainer._save_best_and_last(3, 2.0, None) == 2.0
    assert trainer._save_best_and_last(4, 3.0, 2.0) == 2.0  # worse: best.ckpt stays
    best = tckpt.load_checkpoint_file(str(tmp_path / "best.ckpt"))
    last = tckpt.load_checkpoint_file(str(tmp_path / "last.ckpt"))
    assert (best["iter"], best["best_loss"]) == (3, 2.0)
    assert (last["iter"], last["best_loss"]) == (4, 2.0)  # last records the running best

    loaded = Trainer(tcfg, trainer.config, BOUNDS, device="cpu")
    assert loaded.load_checkpoint(str(tmp_path / "last.ckpt")) == (4, 2.0)
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            loaded.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert (loaded.optimizer.count, loaded.optimizer.mini_step) == (1, 1)
    # The pending micro-step and the moments came back: the next update is equal.
    for t in (trainer, loaded):
        t.train_one_step(batch, 3)
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            loaded.model.state_dict().values()):
        assert torch.equal(a, b), name

    args = {"model": {"embedding_dim": 24}, "batch_size": 2}
    tckpt.save_training_args(str(tmp_path), args)
    assert tckpt.load_training_args(str(tmp_path / "best.ckpt")) == args


class Interrupted(Exception):
    pass


class InMemoryLoader:
    """Batches of ``batch_size`` from a sample pool, in the sampler's order;
    with ``stop_at_epoch``, the run is cut when that epoch starts."""

    def __init__(self, pool, batch_size, sampler, stop_at_epoch=None):
        self.pool, self.batch_size, self.sampler = pool, batch_size, sampler
        self.stop_at_epoch, self.epochs = stop_at_epoch, 0

    def __len__(self):
        return len(self.sampler) // self.batch_size

    def __iter__(self):
        if self.epochs == self.stop_at_epoch:
            raise Interrupted
        self.epochs += 1
        order = list(self.sampler)
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield {k: v[idx] for k, v in self.pool.items()}


def test_resume_equals_continuing(tmp_path):
    """8 steps straight through vs a run cut after its checkpoint at step 3,
    resumed by a new trainer from last.ckpt: the same parameters. Epochs of
    2 batches reseed every 2 epochs, so the resumed run must restore the
    sampler's block."""
    _, tcfg = configs(8, **SMALL)
    rng = np.random.default_rng(10)
    pool = mesh_batch(rng, B=8)
    val = [mesh_batch(rng)]

    def run(directory, stop_at_epoch=None, resume=None):
        fields = dict(train_iters=8, batch_size=2, val_freq=4, skip_train_val=True,
                      set_epoch_every=2, checkpoint_dir=str(directory),
                      eval_num_inference_steps=2)
        trainer = Trainer(tcfg, TrainerConfig(**fields), BOUNDS, device="cpu")
        start_iter = 0
        if resume:
            step, _ = trainer.load_checkpoint(resume)
            start_iter = step + 1
        sampler = WeightedEpochSampler(np.ones(8), num_samples=4, replacement=True, seed=3)
        loader = InMemoryLoader(pool, 2, sampler, stop_at_epoch)
        trainer.run_training(loader, val, start_iter=start_iter)
        return trainer

    straight = run(tmp_path / "a")
    with pytest.raises(Interrupted):
        run(tmp_path / "b", stop_at_epoch=2)
    assert tckpt.load_checkpoint_file(str(tmp_path / "b" / "last.ckpt"))["iter"] == 3
    resumed = run(tmp_path / "c", resume=str(tmp_path / "b" / "last.ckpt"))
    assert resumed.optimizer.count == straight.optimizer.count == 8
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("path", CKPTS)
def test_jax_checkpoint_reader_matches_flax(path):
    with open(os.path.join(DATA, path), "rb") as f:
        payload = pickle.load(f)
    ref = serialization.msgpack_restore(payload["params"])
    params, step, best_loss = tckpt.read_jax_checkpoint(os.path.join(DATA, path))
    assert (step, best_loss) == (payload["iter"], payload["best_loss"])
    assert tckpt.is_jax_checkpoint(os.path.join(DATA, path))
    ref_leaves, ref_tree = jax.tree_util.tree_flatten(ref)
    leaves, tree = jax.tree_util.tree_flatten(params)
    assert tree == ref_tree
    for a, b in zip(leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_trainer_loads_a_jax_checkpoint(caplog):
    """The committed fixtures pickle no optax state (``None``): the
    optimizer starts afresh, and the trainer says so."""
    path = os.path.join(DATA, "task_success/cube_stacking/last.ckpt")
    trainer = Trainer(fixture_configs(False)[1], TrainerConfig(), BOUNDS, device="cpu")
    with caplog.at_level("INFO", logger="nvblox_mindmap_torch.trainer"):
        step, best_loss = trainer.load_checkpoint(path)
    assert (step, round(best_loss, 4)) == (35999, 0.4075)
    ref = flax_to_state_dict(load_params("task_success/cube_stacking/last.ckpt"))
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, ref[name]), name
    assert tckpt.read_jax_opt_state(path) is None
    assert trainer.optimizer.count == 0 and not trainer.optimizer.adamw.state
    assert "holds no optimizer state" in caplog.text


@pytest.mark.parametrize("accumulate", [1, 2])
def test_resume_from_a_jax_checkpoint_matches_jax(tmp_path, accumulate):
    """The JAX trainer takes 3 updates (with 2-step accumulation: 3 updates
    and one pending micro-step) and saves; the port resumes from that file,
    and its next update, on the same batch, noise and timesteps, matches the
    JAX trainer's at the same learning rate. Fresh optimizer state would be
    off by ~1e-3 here (lr 1e-3; the schedule at update 3 of a run of 8 is at
    0.75 of it). Tolerance: 1e-6, except the attention k-projection biases,
    whose gradient is zero up to rounding (softmax is shift-invariant), so
    Adam steps them by rounding noise: held to one step, lr."""
    jcfg, tcfg = configs(8, **SMALL)
    rng = np.random.default_rng(12)
    batches = [mesh_batch(rng) for _ in range(4)]
    fields = dict(batch_size=2, train_iters=8, initial_learning_rate=1e-3,
                  accumulate_grad_batches=accumulate)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(**fields), BOUNDS)
    params, opt_state = jt.init_state(batches[0])
    n = 3 * accumulate + (accumulate - 1)  # micro-steps before the checkpoint
    for step in range(n):
        params, opt_state, _ = jt.train_one_step(params, opt_state, batches[step % 4], step)
    path = str(tmp_path / "last.ckpt")
    from nvblox_mindmap_tpu.training.checkpoint import save_checkpoint_file

    save_checkpoint_file(path, params, opt_state, n - 1, 0.5)
    batch = batches[n % 4]
    # The JAX trainer's step n draws from fold_in(PRNGKey(seed), n).
    noise, timesteps = jax_step_noise(
        jcfg, jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(BOUNDS), jcfg),
        jax.random.fold_in(jax.random.PRNGKey(0), n))
    params, _, _ = jt.train_one_step(params, opt_state, batch, n)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))

    trainer = Trainer(tcfg, TrainerConfig(**fields), BOUNDS, device="cpu")
    assert trainer.load_checkpoint(path) == (n - 1, 0.5)
    optimizer = trainer.optimizer
    assert (optimizer.count, optimizer.mini_step) == (3, accumulate - 1)
    lr = float(jopt.linear_lr_schedule(1e-3, 0.5, 8)(3))
    assert optimizer.schedule(optimizer.count) == lr
    trainer.train_one_step(batch, n, noise, timesteps)
    assert optimizer.count == 4
    for name, value in trainer.model.state_dict().items():
        atol = lr if "k_proj.bias" in name else 1e-6
        torch.testing.assert_close(value, ref[name], atol=atol, rtol=0, msg=name)


def test_flash_refuses_under_grad(monkeypatch):
    """The kernels have no backward: under autograd they raise, on the CPU
    too. The train step passes the eager impl whatever the default is; the
    eval batch samples through the installed flash impl."""
    q = torch.randn(1, 2, 3, 4, requires_grad=True)
    k, v = torch.randn(1, 2, 5, 4), torch.randn(1, 2, 5, 4)
    for call in (lambda: fa.flash_attention(q, k, v),
                 lambda: fa.run_kernel(fa.KERNELS[0], q, k, v)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    fa.flash_attention(q.detach(), k, v)

    _, tcfg = configs(8, **dict(SMALL, diffusion_timesteps=10))
    batch = mesh_batch(np.random.default_rng(11))
    trainer = trainer_for(tcfg)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    set_default_attention_impl("flash")
    prepared = tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        trainer.model(prepared, torch.zeros(2, 1, 1, 9), torch.zeros(2))
    calls.clear()
    losses = trainer.train_one_step(batch, 0)
    assert calls == [] and torch.isfinite(losses["total"])
    trainer.eval_step(batch, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 3 + 10 * 10


def test_init_matches_flax(depth2_backbones):
    """Full width: embedding 120, 8 heads, 768-d vertex features and the
    RADIO ViT-B/16 width (at depth 2)."""
    width = dict(embedding_dim=120, num_attn_heads=8, diffusion_timesteps=100,
                 fps_subsampling_factor=5)
    jcfg, tcfg = image_configs("rgbd_and_mesh", feature_type="radio_v25_b",
                               feature_image_size=(2, 2), vertex_feature_dim=768, **width)
    batch = make_image_batch(np.random.default_rng(12), 1, 2, 32, BOUNDS, n_vertices=10,
                             feature_dim=768)
    _, _, params = init_jax(jcfg, batch, BOUNDS)
    ref = flax_to_state_dict(params)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = tda.DiffuserActor(tcfg, device="cpu")
    compared = 0
    for name, value in model.state_dict().items():
        r = ref[name]
        if not r.any() or bool((r == 1).all()):  # zeros (biases, AdaLN), ones (LayerNorm)
            assert torch.equal(value, r), name
        elif r.numel() >= 10_000:
            ratio = float(value.std() / r.std())
            assert abs(ratio - 1) <= 0.05, (name, ratio)
            compared += 1
    assert compared >= 100


@pytest.mark.parametrize("data_type", ["mesh", "rgbd", "rgbd_and_mesh"])
def test_train_batch_template_matches_jax(data_type):
    fields = dict(data_type=data_type, predict_head_yaw=data_type == "mesh")
    jcfg = jda.DiffuserActorConfig(**fields)
    ref = jtrainer.make_train_batch_template(jcfg, batch_size=3, ncam=2)
    out = make_train_batch_template(tda.DiffuserActorConfig(**fields), batch_size=3, ncam=2)
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        if v is None:
            assert out[k] is None, k
        else:
            assert out[k].dtype == v.dtype and np.array_equal(out[k], v), k


def test_timers_record_and_report():
    ttimers.reset_timers()
    for _ in range(3):
        with ttimers.Timer("step/train", synchronize=True):
            pass
    ttimers.Timer("step/load_batch").stop()
    lines = ttimers.timer_status_string().splitlines()
    assert lines[0] == jtimers.timer_status_string().splitlines()[0]
    assert [line.split("\t")[:2] for line in lines[1:]] == [["step/load_batch", "1"],
                                                            ["step/train", "3"]]
    ttimers.reset_timers()
