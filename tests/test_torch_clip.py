"""Torch port vs the JAX package: the CLIP ResNet-50 FPN extractor.

Each module (``FrozenBatchNorm`` inside a ``Bottleneck`` with and without a
downsample path, ``ModifiedResNetFeatures`` at layers (1, 1, 1, 1) and width
8, the FPN at an odd size) and the full-width ``ClipResNet50Fpn`` at
feature sizes (4, 4) and (5, 6); the converter from a CLIP state dict; the
checkpoint wiring (a trunk-only npz, an npz with an FPN, ``make_feature_fn``);
the FPN's gradients under the frozen trunk; and one rgbd_and_mesh train
step with the extractor inside the model.

Weights come from one JAX init of a small rgbd_and_mesh model with the
full-width extractor (module-scoped), with random batch statistics and FPN
biases so that every term is exercised; inputs from numpy seeds.

Tolerances: module outputs atol 1e-4 on activations of magnitude ~1 (fp32,
summation orders of convolutions with up to 4608 terms; measured ~1e-6);
the converter bit for bit; the extractor's FPN gradients (sums over the
feature grid reaching ~70) atol 1e-6 of each tensor's largest entry and
rtol 1e-4 (measured 6e-5 at most, ~1e-6 relative), the train
step's loss 1e-5 relative and gradients as ``tests/test_torch_training.py``
holds them; after one AdamW update the trunk is bit for bit unchanged and
the FPN levels res3 does not read (zero gradient, decoupled decay only)
within 1e-7 of optax's.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.models import clip_resnet_fpn as jclip
from nvblox_mindmap_tpu.models import pretrained as jpre
from nvblox_mindmap_tpu.models import weight_conversion as jwc
from nvblox_mindmap_tpu.training import optimizer as jopt
from nvblox_mindmap_torch.models import clip_resnet_fpn as tclip
from nvblox_mindmap_torch.models import pretrained as tpre
from nvblox_mindmap_torch.models import weight_conversion as twc
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor
from nvblox_mindmap_torch.models.weights import (
    flax_paths,
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from nvblox_mindmap_torch.training import optimizer as topt
from tests.test_torch_image_path import image_configs, init_jax, make_image_batch
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    BOUNDS,
    one_torch_thread,
)
from tests.test_torch_training import SMALL, jax_train_step, pose8, trainer_for

ATOL = 1e-4
DEAD_LEVELS = ("inner_0", "inner_1", "layer_0", "layer_1", "layer_3", "layer_4")


def perturb(tree, seed):
    """Random batch statistics and FPN biases (flax inits them to 0 / 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def images(seed, B, H, W):
    return np.random.default_rng(seed).uniform(size=(B, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def clip_model():
    """A small rgbd_and_mesh model with the full-width CLIP extractor at a
    4x4 feature grid (32x32 images, one camera): (JAX config, torch config,
    batch, flax params)."""
    jcfg, tcfg = image_configs("rgbd_and_mesh", feature_type="clip_resnet50_fpn",
                               feature_image_size=(4, 4), vertex_feature_dim=8, **SMALL)
    rng = np.random.default_rng(0)
    batch = make_image_batch(rng, 2, 1, 32, BOUNDS, n_vertices=16, feature_dim=8)
    batch["gt_gripper_pred"] = pose8(rng, (2, 1, 1))
    _, _, params = init_jax(jcfg, batch, BOUNDS)
    params["encoder"]["feature_extractor"] = perturb(params["encoder"]["feature_extractor"], 1)
    return jcfg, tcfg, batch, params


@pytest.fixture(scope="module")
def extractor_params(clip_model):
    return clip_model[3]["encoder"]["feature_extractor"]


def small_trunk_params(x):
    module = jclip.ModifiedResNetFeatures(layers=(1, 1, 1, 1), width=8)
    params = jax.jit(module.init)(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    return module, perturb(params, 3)


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("c_in,planes,stride", [(16, 4, 1), (16, 4, 2), (8, 4, 1)])
def test_bottleneck_matches_jax(c_in, planes, stride):
    """Identity path as is (16 -> 4 x 4 channels), through the downsample
    (anti-aliased pool, 1x1 conv, FrozenBatchNorm) at stride 2, and at
    stride 1 with a change of width; an odd spatial size (floor pooling)."""
    x = images(4, 2, 9, 7).repeat(6, axis=-1)[..., :c_in]
    module = jclip.Bottleneck(planes, stride)
    params = perturb(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    block = tclip.Bottleneck(c_in, planes, stride)
    assert block.has_downsample == ("downsample_conv" in params)
    load_flax_params(block, params)
    out = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)


def test_trunk_and_fpn_match_jax():
    """``ModifiedResNetFeatures`` at layers (1, 1, 1, 1), width 8, on a
    40x48 input: its five maps; then the FPN over them, where res4 (2x3) is
    upsampled to res3 (5x6): torch's ``nearest`` differs from JAX there,
    ``nearest-exact`` does not."""
    x = images(6, 2, 40, 48)
    module, params = small_trunk_params(x)
    ref = module.apply({"params": params}, jnp.asarray(x))
    trunk = tclip.ModifiedResNetFeatures(layers=(1, 1, 1, 1), width=8)
    load_flax_params(trunk, params)
    feats = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [f.shape[1] for f in feats] == trunk.out_channels() == [8, 32, 64, 128, 256]
    for f, r in zip(feats, ref):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).detach().numpy(), np.asarray(r),
                                   atol=ATOL, rtol=0)
    assert [tuple(f.shape[-2:]) for f in feats][2:] == [(5, 6), (2, 3), (1, 1)]

    fpn = jclip.FeaturePyramidNetwork(16)
    fparams = perturb(jax.jit(fpn.init)(jax.random.PRNGKey(3), ref)["params"], 7)
    fref = fpn.apply({"params": fparams}, ref)
    tfpn = tclip.FeaturePyramidNetwork(trunk.out_channels(), 16)
    load_flax_params(tfpn, fparams)
    with torch.no_grad():
        outs = tfpn(feats)
        for i, (o, r) in enumerate(zip(outs, fref)):
            np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                       atol=ATOL, rtol=0, err_msg=f"level {i}")
            assert torch.equal(tfpn.level(feats, i), o)


@pytest.mark.parametrize("feature_image_size", [(4, 4), (5, 6)])
def test_extractor_matches_jax(extractor_params, feature_image_size):
    """The full-width extractor (CLIP normalization, bilinear resize of a
    24x30 input to 8x the feature size, trunk, FPN, res3)."""
    x = images(8, 2, 24, 30)
    ref = jclip.ClipResNet50Fpn(feature_image_size=feature_image_size).apply(
        {"params": extractor_params}, jnp.asarray(x))
    module = tclip.ClipResNet50Fpn(feature_image_size)
    load_flax_params(module, extractor_params)
    out = module(torch.from_numpy(x))
    assert out.shape == (2, *feature_image_size, 120)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_fpn_gradients_match_jax(extractor_params):
    """d(sum(features * w))/d params: JAX's ``jax.grad`` under its
    ``stop_gradient`` (zeros on the trunk and the unread FPN levels) and
    the port's autograd (no gradient there at all)."""
    x = images(9, 2, 32, 32)
    w = np.random.default_rng(10).normal(size=(2, 4, 4, 120)).astype(np.float32)
    jmodule = jclip.ClipResNet50Fpn(feature_image_size=(4, 4))
    ref = jax.jit(jax.grad(lambda p: jnp.sum(
        jmodule.apply({"params": p}, jnp.asarray(x)) * w)))(extractor_params)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref))
    module = tclip.ClipResNet50Fpn((4, 4))
    load_flax_params(module, extractor_params)
    (module(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    for name, p in module.named_parameters():
        dead = name.split(".")[1] in DEAD_LEVELS
        if name.startswith("backbone.") or dead:
            assert p.grad is None and not ref[name].any(), name
            assert p.requires_grad == name.startswith("fpn."), name
        else:
            scale = float(ref[name].abs().max())
            torch.testing.assert_close(p.grad, ref[name], atol=1e-6 * scale, rtol=1e-4,
                                       msg=name)


# ------------------------------------------------------------------ converter, wiring


def clip_state_dict(seed, prefix="visual."):
    """A CLIP RN50 visual state dict (torch layout, batch-norm running
    statistics, the attention-pool head the converter skips)."""
    rng = np.random.default_rng(seed)
    trunk = tclip.ModifiedResNetFeatures()
    sd = {}
    for name, p in trunk.named_parameters():
        module, _, leaf = name.rpartition(".")
        module = module.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1")
        module = module.replace("_", ".", 1) if module.startswith("layer") else module
        leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        sd[f"{prefix}{module}.{leaf}"] = rng.normal(size=tuple(p.shape)).astype(np.float32)
    sd[f"{prefix}attnpool.c_proj.weight"] = rng.normal(size=(1024, 2048)).astype(np.float32)
    return sd


def test_converter_matches_jax():
    sd = clip_state_dict(11)
    ref = jwc.convert_clip_resnet_weights(sd)
    for prefix in ("visual.", ""):
        out = twc.convert_clip_resnet_weights(
            {k.replace("visual.", prefix): v for k, v in sd.items()})
        flat_ref = jax.tree_util.tree_leaves_with_path(ref)
        flat_out = jax.tree_util.tree_leaves_with_path(out)
        assert [p for p, _ in flat_out] == [p for p, _ in flat_ref]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_out, flat_ref))
    # The converted trunk loads strictly into the port's trunk.
    load_flax_params(tclip.ModifiedResNetFeatures(), out["params"])


def test_bridge_round_trip_and_masks_match_jax(clip_model):
    """``state_dict_to_flax`` inverts the bridge on the whole CLIP model;
    the decay and trainable masks pick the JAX package's leaves (batch-norm
    scales and biases and conv biases do not decay; only the FPN of the
    extractor trains)."""
    _, tcfg, _, params = clip_model
    model = DiffuserActor(tcfg, device="cpu")
    load_flax_params(model, params)
    back = state_dict_to_flax(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        assert np.array_equal(node, leaf), path
    for port, ref in ((topt.decay_mask(model), jopt._decay_mask(params)),
                      (topt.frozen_feature_extractor_mask(model),
                       jopt.frozen_feature_extractor_mask(params))):
        ref = {k: bool(v.reshape(-1)[0]) for k, v in flax_to_state_dict(ref).items()}
        assert port == ref
    paths = flax_paths(model)
    assert paths["encoder.feature_extractor.backbone.layer1_0.bn1.weight"][-2:] == ("bn1", "scale")
    assert {n for n, p in model.named_parameters() if p.requires_grad and "feature_extractor" in n} \
        == {n for n in paths if ".fpn." in n}


def save_clip_npz(path, extractor_params, with_fpn):
    params = {"backbone": extractor_params["backbone"]}
    if with_fpn:
        params["fpn"] = extractor_params["fpn"]
    twc.save_variables_npz(path, {"params": params})


def test_pretrained_wiring_matches_jax(clip_model, extractor_params, fast_tmp_path, caplog):
    """An npz with the FPN: ``build_backbone`` and ``make_feature_fn`` equal
    the JAX package's, and ``load_backbone_into_model`` grafts both parts.
    A trunk-only npz (what the converter writes): a fresh FPN, with the
    warning; grafted into a model, only the trunk changes."""
    full = str(fast_tmp_path / "clip_fpn.npz")
    trunk_only = str(fast_tmp_path / "clip_trunk.npz")
    save_clip_npz(full, extractor_params, True)
    save_clip_npz(trunk_only, extractor_params, False)
    x = images(12, 1, 40, 40)
    jmodule, jparams = jpre.build_backbone("clip_resnet50_fpn", full, (4, 4))
    ref = np.asarray(jmodule.apply({"params": jparams}, jnp.asarray(x)))
    backbone = tpre.build_backbone("clip_resnet50_fpn", full, (4, 4), device="cpu")
    np.testing.assert_allclose(backbone(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=ATOL, rtol=0)
    ref_fn = jpre.make_feature_fn("clip_resnet50_fpn", (16, 16), full, (4, 4))(x[0])
    out_fn = tpre.make_feature_fn("clip_resnet50_fpn", (16, 16), full, (4, 4), device="cpu")(x[0])
    assert out_fn.shape == (16, 16, 120)
    np.testing.assert_allclose(out_fn.numpy(), np.asarray(ref_fn), atol=ATOL, rtol=0)

    with caplog.at_level(logging.WARNING):
        fresh = tpre.build_backbone("clip_resnet50_fpn", trunk_only, (4, 4), device="cpu")
    assert "no 'fpn' subtree" in caplog.text
    ref_trunk = flax_to_state_dict({"backbone": extractor_params["backbone"]})
    for name, value in fresh.state_dict().items():
        if name.startswith("backbone."):
            assert torch.equal(value, ref_trunk[name]), name
    assert not torch.equal(fresh.fpn.inner_2.weight, backbone.fpn.inner_2.weight)

    _, tcfg, _, _ = clip_model
    model = DiffuserActor(tcfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tpre.load_backbone_into_model(model, "clip_resnet50_fpn", trunk_only)
    for name, value in model.state_dict().items():
        trunk = name.partition("encoder.feature_extractor.")[2]
        want = ref_trunk[trunk] if trunk.startswith("backbone.") else before[name]
        assert torch.equal(value, want), name
    tpre.load_backbone_into_model(model, "clip_resnet50_fpn", full)
    want = flax_to_state_dict(extractor_params)
    for name, value in model.encoder.feature_extractor.state_dict().items():
        assert torch.equal(value, want[name]), name


# ------------------------------------------------------------------ training


def test_chunked_backbone_keeps_the_fpn_graph(clip_model):
    """``backbone_chunk_images`` runs the extractor over chunks of images:
    the FPN's gradients through the chunked call equal the one-call
    gradients (the trunk stays out of autograd either way), within 1e-6 of
    each tensor's largest entry (gradients up to ~340; a convolution over
    another batch size sums in another order: 4.5e-7 measured)."""
    import dataclasses

    from nvblox_mindmap_torch.models import diffuser_actor as tda

    _, tcfg, batch, params = clip_model
    grads = []
    for chunk in (None, 1):
        model = tda.DiffuserActor(dataclasses.replace(tcfg, backbone_chunk_images=chunk),
                                  device="cpu")
        load_flax_params(model, params)
        prepared = tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu")
        feats, _, _ = model.encoder.encode_images(prepared["rgbs"], prepared["pcds"])
        feats.square().sum().backward()
        grads.append({n: p.grad for n, p in model.encoder.feature_extractor.named_parameters()
                      if p.grad is not None})
    assert sorted(grads[0]) == sorted(grads[1]) and len(grads[0]) == 8
    for name, grad in grads[0].items():
        rel = ((grads[1][name] - grad).abs().max() / grad.abs().max()).item()
        assert rel <= 1e-6, (name, rel)


def test_train_step_with_the_fpn_matches_jax(clip_model):
    """One rgbd_and_mesh train step with the CLIP extractor: loss and every
    gradient equal JAX's (the trunk has none; the unread FPN levels none in
    the port, zeros in JAX); then one AdamW update from those gradients
    (decay 0.1, so a wrong decay shows): the trunk stays bit for bit, and
    the unread levels are decayed exactly as optax decays them."""
    jcfg, tcfg, batch, params = clip_model
    ref_losses, ref_grads, noise, timesteps = jax_train_step(jcfg, params, batch, seed=3)
    hyper = dict(initial_learning_rate=1e-3, weight_decay=0.1, train_iters=4)
    trainer = trainer_for(tcfg, params, **hyper)
    losses = trainer.compute_loss_and_grads(batch, 0, noise, timesteps)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(v), rtol=1e-5, atol=0,
                                   err_msg=k)
    ref = flax_to_state_dict(ref_grads)
    fpn_grads = 0
    for name, p in trainer.model.named_parameters():
        dead = ".fpn." in name and name.split(".")[3] in DEAD_LEVELS
        if not p.requires_grad or dead:
            assert p.grad is None and not ref[name].any(), name
            continue
        if p.grad is None:
            assert name == "encoder.goal_gripper_embed"
            continue
        fpn_grads += ".fpn." in name
        torch.testing.assert_close(p.grad, ref[name], atol=1e-5, rtol=1e-4, msg=name)
    assert fpn_grads == 8  # inner_2..4 and layer_2, kernel and bias

    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.optimizer.step()
    tx = jopt.make_optimizer(
        params, initial_learning_rate=1e-3, weight_decay=0.1, end_factor=0.5, total_iters=4,
        trainable_mask=jopt.frozen_feature_extractor_mask(params, fpn_trainable=True))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(ref_grads, tx.init(jparams), jparams)
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)))
    for name, value in trainer.model.state_dict().items():
        if ".backbone." in name:
            assert torch.equal(value, before[name]), name
        elif ".fpn." in name and name.split(".")[3] in DEAD_LEVELS:
            torch.testing.assert_close(value, want[name], atol=1e-7, rtol=0, msg=name)
            if name.endswith("weight"):  # kernels decay, biases do not
                assert not torch.equal(value, before[name]), name
