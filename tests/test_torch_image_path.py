"""Torch port vs the JAX package: the image path (masks, resize, feature
extractors, ``encode_images``, ``encode``, the backbone checkpoints).
Whole-path trajectories are in ``tests/test_torch_image_trajectories.py``.

Inputs come from numpy seeds; weights from the flax init, converted by the
port's bridge (``models/weights.py``), which loads strictly. Sampler noise
is the JAX sampler's own (``jax_sampler_noise``).

Tolerances:
- masks exact; resize atol 1e-6 (fp32, the same antialiased bilinear
  weights summed in another order); normalization atol 1e-6;
- the RGB extractor, ``encode_images`` and ``encode`` with it: atol 1e-5
  (``FEATURE_ATOL``, fp32);
- the ViT (and anything after it): mean abs <= 1e-2 and max abs <= 0.1 on
  LayerNorm'd features of mean magnitude ~0.8. Both sides run bf16 and
  round at different places (flax on XLA, torch's CPU kernels); the
  measured noise is ~0.004 mean / ~0.05 max, and an fp32 version of the
  same function is itself ~0.03 max off the bf16 flax module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.models import diffuser_actor as jda
from nvblox_mindmap_tpu.models import encoder as jenc
from nvblox_mindmap_tpu.models import feature_extractors as jfe
from nvblox_mindmap_tpu.models import normalization as jnorm
from nvblox_mindmap_tpu.models import pretrained as jpre
from nvblox_mindmap_tpu.models import weight_conversion as jwc
from nvblox_mindmap_tpu.ops import masks as jmasks
from nvblox_mindmap_torch.models import diffuser_actor as tda
from nvblox_mindmap_torch.models import encoder as tenc
from nvblox_mindmap_torch.models import feature_extractors as tfe
from nvblox_mindmap_torch.models import normalization as tnorm
from nvblox_mindmap_torch.models import pretrained as tpre
from nvblox_mindmap_torch.models import weight_conversion as twc
from nvblox_mindmap_torch.models.weights import load_flax_params
from nvblox_mindmap_torch.ops import masks as tmasks
from tests.test_torch_fixture_parity import load_params
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    BOUNDS,
    FEATURE_ATOL,
    one_torch_thread,
)

VIT_MEAN_ATOL = 1e-2
VIT_MAX_ATOL = 0.1
# Published geometry of the two ViT backbones (feature_extractors.py).
VIT_GEOMETRY = {
    "radio_v25_b": dict(patch_size=16, width=768, num_heads=12),
    "dino_v2_vits14": dict(patch_size=14, width=384, num_heads=6, use_layer_scale=True),
}
VIT_DEPTH = 2


def assert_bf16_close(out, ref, what=""):
    diff = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert diff.mean() <= VIT_MEAN_ATOL, (what, diff.mean())
    assert diff.max() <= VIT_MAX_ATOL, (what, diff.max())


# ------------------------------------------------------------------ masks, resize


def test_downscale_mask_matches_jax():
    mask = np.random.default_rng(0).uniform(size=(2, 3, 16, 24)) > 0.05
    for factor in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            tmasks.downscale_mask(torch.from_numpy(mask), factor).numpy(),
            np.asarray(jmasks.downscale_mask(jnp.asarray(mask), factor)))


def test_erode_mask_matches_jax():
    mask = np.random.default_rng(1).uniform(size=(20, 17)) > 0.1
    for kernel_size, iterations in ((1, 1), (3, 1), (3, 2), (5, 3)):
        np.testing.assert_array_equal(
            tmasks.erode_mask(torch.from_numpy(mask), kernel_size, iterations).numpy(),
            np.asarray(jmasks.erode_mask(jnp.asarray(mask), kernel_size, iterations)))


def test_border_mask_matches_jax():
    for shape, percent in (((20, 30), 10), ((64, 64, 3), 5), ((10, 10), 0), ((40, 8), 10)):
        np.testing.assert_array_equal(tmasks.get_border_mask(shape, percent).numpy(),
                                      np.asarray(jmasks.get_border_mask(shape, percent)))


@pytest.mark.parametrize("src,dst", [(64, 16), (512, 32), (16, 64), (20, 20)])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(src).normal(size=(2, src, src, 5)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, dst, dst, 5), method="bilinear")
    out = tfe.resize_bilinear(torch.from_numpy(x), (dst, dst))
    assert out.shape == (2, dst, dst, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_normalize_pointcloud_matches_jax():
    lo, hi = BOUNDS
    pcd = np.random.default_rng(2).uniform(lo - 0.2, hi + 0.2, size=(2, 2, 8, 8, 3))
    pcd = pcd.astype(np.float32)
    ref, ref_mask = jnorm.normalize_pointcloud(jnp.asarray(pcd), jnp.asarray(BOUNDS))
    out, mask = tnorm.normalize_pointcloud(torch.from_numpy(pcd), torch.from_numpy(BOUNDS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert not mask.all() and mask.any()


# ------------------------------------------------------------------ extractors


def test_rgb_extractor_matches_jax():
    rgb = np.random.default_rng(3).uniform(size=(3, 64, 48, 3)).astype(np.float32)
    ref = jfe.RgbFeatureExtractor(feature_image_size=(16, 12)).apply({}, jnp.asarray(rgb))
    out = tfe.make_feature_extractor("rgb", (16, 12))(torch.from_numpy(rgb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def jax_vit(feature_type, feature_image_size, num_prefix_tokens=1, mean_std=None):
    geometry = dict(VIT_GEOMETRY[feature_type])
    mean_std = mean_std or jfe.NORMALIZATION[jfe.FeatureExtractorType(feature_type)]
    return jfe.VitFeatureExtractor(depth=VIT_DEPTH, feature_image_size=feature_image_size,
                                   num_prefix_tokens=num_prefix_tokens, mean_std=mean_std,
                                   **geometry)


def torch_vit(feature_type, feature_image_size, num_prefix_tokens=1, mean_std=None):
    mean_std = mean_std or tfe.NORMALIZATION[tfe.FeatureExtractorType(feature_type)]
    return tfe.VitFeatureExtractor(depth=VIT_DEPTH, feature_image_size=feature_image_size,
                                   num_prefix_tokens=num_prefix_tokens, mean_std=mean_std,
                                   **VIT_GEOMETRY[feature_type])


def random_vit_params(module, rgb, seed):
    """Flax init, with the LayerNorm, LayerScale and prefix parameters
    perturbed so that a dropped or transposed one shows."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(rgb))["params"]
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        names = {getattr(p, "key", "") for p in path}
        if names & {"scale"} or any(str(n).startswith("ls") for n in names):
            return (leaf * rng.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)
        if "bias" in names or "prefix_tokens" in names:
            return (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.mark.parametrize("feature_type", sorted(VIT_GEOMETRY))
def test_vit_matches_jax(feature_type):
    """Published widths, depth 2, a 4x4 patch grid, 2 images."""
    rgb = np.random.default_rng(4).uniform(size=(2, 72, 72, 3)).astype(np.float32)
    jmodule = jax_vit(feature_type, (4, 4))
    params = random_vit_params(jmodule, rgb, seed=5)
    ref = jax.jit(jmodule.apply)({"params": params}, jnp.asarray(rgb))
    module = torch_vit(feature_type, (4, 4))
    load_flax_params(module, params)
    out = module(torch.from_numpy(rgb))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert_bf16_close(out.numpy(), ref, feature_type)


def test_unported_extractor_raises():
    """The last extractor the port used to refuse, CLIP ResNet-50 FPN, is
    built by the registry and matches the JAX package's (a 4x4 feature grid,
    the smallest whose res5 is not empty, from a 20x20 input; the
    module-level parity is in
    ``tests/test_torch_clip.py``). A type the registry does not know
    raises."""
    rgb = np.random.default_rng(14).uniform(size=(1, 20, 20, 3)).astype(np.float32)
    jmodule = jfe.make_feature_extractor(jfe.FeatureExtractorType.CLIP_RESNET50_FPN, (4, 4))
    params = jax.jit(jmodule.init)(jax.random.PRNGKey(0), jnp.asarray(rgb))["params"]
    ref = jmodule.apply({"params": params}, jnp.asarray(rgb))
    module = tfe.make_feature_extractor("clip_resnet50_fpn", (4, 4), mean_std=((0.5,) * 3,) * 2)
    load_flax_params(module, params)
    out = module(torch.from_numpy(rgb))
    assert out.shape == (1, 4, 4, tfe.get_feature_dim("clip_resnet50_fpn")) == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        tfe.make_feature_extractor("clip_vit_l14")


# ------------------------------------------------------------------ encode


def image_configs(data_type, feature_type="rgb", feature_image_size=(4, 4),
                  vertex_feature_dim=3, **fields):
    """Matching (JAX, torch) configs for an image model."""
    jcfg = jda.DiffuserActorConfig(data_type=data_type,
                                   feature_type=jfe.FeatureExtractorType(feature_type),
                                   feature_image_size=feature_image_size, **fields)
    tcfg = tda.DiffuserActorConfig(data_type=data_type, feature_type=feature_type,
                                   feature_image_size=feature_image_size,
                                   vertex_feature_dim=vertex_feature_dim, **fields)
    return jcfg, tcfg


def make_image_batch(rng, B, ncam, size, bounds, n_vertices=0, feature_dim=3):
    """Gripper history, RGB-D (a few points out of bounds, the top quarter
    of camera 0 invalid) and, with ``n_vertices``, a mesh with invalid
    vertices."""
    lo, hi = np.asarray(bounds)
    pos = rng.uniform(lo, hi, size=(B, 3, 1, 3))
    quat = rng.normal(size=(B, 3, 1, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    closed = rng.integers(0, 2, size=(B, 3, 1, 1))
    span = hi - lo
    valid = np.ones((B, ncam, size, size), bool)
    valid[:, 0, : size // 4] = False
    batch = {
        "gripper_history": np.concatenate([pos, quat, closed], -1).astype(np.float32),
        "rgbs": rng.uniform(0, 1, size=(B, ncam, size, size, 3)).astype(np.float32),
        "pcds": rng.uniform(lo - 0.02 * span, hi + 0.02 * span,
                            size=(B, ncam, size, size, 3)).astype(np.float32),
        "pcd_valid_mask": valid,
    }
    if n_vertices:
        mask = np.ones((B, n_vertices), bool)
        mask[:, -n_vertices // 4:] = False
        batch.update(
            vertices=rng.uniform(lo, hi, size=(B, n_vertices, 3)).astype(np.float32),
            vertex_features=rng.uniform(0, 1, size=(B, n_vertices, feature_dim)).astype(
                np.float32),
            vertices_valid_mask=mask,
        )
    return batch


SMALL = dict(embedding_dim=24, num_attn_heads=4, diffusion_timesteps=100,
             fps_subsampling_factor=4)


def init_jax(jcfg, batch, bounds, seed=1):
    jmodel = jda.DiffuserActor(jcfg)
    jprep = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(bounds), jcfg)
    B = batch["gripper_history"].shape[0]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jprep,
                                     jnp.zeros((B, 1, 1, 9)), jnp.zeros((B,), jnp.int32))
    return jmodel, jprep, jax.tree_util.tree_map(np.asarray, variables["params"])


def jax_encode(jmodel, params, jprep):
    fn = jax.jit(lambda v, p: jmodel.apply(
        v, p.get("rgbs"), p.get("pcds"), p.get("pcd_valid_mask"), p.get("vertex_features"),
        p.get("vertices"), p.get("vertices_valid_mask"), None, p["gripper_history"],
        p["curr_closedness"], method=jda.DiffuserActor.encode))
    return fn({"params": params}, jprep)


def test_prepare_inputs_matches_jax_relative_uint8():
    jcfg, tcfg = image_configs("rgbd_and_mesh", **dict(SMALL, relative=True))
    rng = np.random.default_rng(6)
    batch = make_image_batch(rng, 2, 2, 16, BOUNDS, n_vertices=16)
    batch["rgbs"] = rng.integers(0, 256, size=batch["rgbs"].shape).astype(np.uint8)
    ref = jda.prepare_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.asarray(BOUNDS), jcfg)
    out = tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu")
    assert out["rgbs"].dtype == torch.float32
    for name in ("rgbs", "pcds", "gripper_history", "vertices"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), atol=1e-6,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(out["pcd_valid_mask"].numpy(),
                                  np.asarray(ref["pcd_valid_mask"]))


@pytest.mark.parametrize("data_type", ["rgbd", "rgbd_and_mesh"])
def test_encode_with_rgb_extractor_matches_jax(data_type):
    jcfg, tcfg = image_configs(data_type, **SMALL)
    batch = make_image_batch(np.random.default_rng(7), 2, 2, 16, BOUNDS,
                             n_vertices=32 if data_type == "rgbd_and_mesh" else 0)
    jmodel, jprep, params = init_jax(jcfg, batch, BOUNDS)
    ref = jax_encode(jmodel, params, jprep)
    model = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(model, params)
    prep = tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu")
    with torch.no_grad():
        feats, pos, mask = model.encoder.encode_images(prep["rgbs"], prep["pcds"],
                                                       prep["pcd_valid_mask"])
        out = model.encode_prepared(prep)
    n_image = 2 * 4 * 4
    assert feats.shape == (2, n_image, 24)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref["context_feats"])[:, :n_image],
                               atol=FEATURE_ATOL, rtol=0)
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref["context"])[:, :n_image],
                               atol=FEATURE_ATOL, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref["context_mask"])[:, :n_image])
    np.testing.assert_array_equal(out["context_mask"].numpy(), np.asarray(ref["context_mask"]))
    np.testing.assert_array_equal(out["fps_mask"].numpy(), np.asarray(ref["fps_mask"]))
    assert not out["context_mask"].all()
    for name in ("context_feats", "context", "adaln_gripper_feats", "fps_feats", "fps_pos",
                 "gripper_attn_weights"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   atol=FEATURE_ATOL, rtol=0, err_msg=name)


def jax_depth2_factory(*args, **kwargs):
    module = jfe.make_feature_extractor(*args, **kwargs)
    return module.clone(depth=VIT_DEPTH) if isinstance(module, jfe.VitFeatureExtractor) else module


def torch_depth2_factory(t, feature_image_size=(32, 32), mean_std=None, num_prefix_tokens=None):
    t = tfe.FeatureExtractorType(t)
    if t == tfe.FeatureExtractorType.RGB:
        return tfe.make_feature_extractor(t, feature_image_size)
    n = tfe.DEFAULT_PREFIX_TOKENS[t] if num_prefix_tokens is None else num_prefix_tokens
    return torch_vit(t.value, feature_image_size, num_prefix_tokens=n, mean_std=mean_std)


@pytest.fixture
def depth2_backbones(monkeypatch):
    """Both packages build their registry ViTs at depth 2 (widths as published)."""
    monkeypatch.setattr(jenc, "make_feature_extractor", jax_depth2_factory)
    monkeypatch.setattr(jpre, "make_feature_extractor", jax_depth2_factory)
    monkeypatch.setattr(tenc, "make_feature_extractor", torch_depth2_factory)
    monkeypatch.setattr(tpre, "make_feature_extractor", torch_depth2_factory)


@pytest.mark.parametrize("data_type", ["rgbd", "rgbd_and_mesh"])
def test_encode_with_vit_matches_jax(depth2_backbones, data_type):
    """RADIO geometry, a 2x2 patch grid per camera, 2 cameras x 2 images."""
    n_vertices = 16 if data_type == "rgbd_and_mesh" else 0
    jcfg, tcfg = image_configs(data_type, feature_type="radio_v25_b",
                               feature_image_size=(2, 2), vertex_feature_dim=8, **SMALL)
    batch = make_image_batch(np.random.default_rng(8), 2, 2, 32, BOUNDS,
                             n_vertices=n_vertices, feature_dim=8)
    jmodel, jprep, params = init_jax(jcfg, batch, BOUNDS)
    params["encoder"]["feature_extractor"] = random_vit_params(
        jfe.make_feature_extractor(jfe.FeatureExtractorType.RADIO_V25_B, (2, 2)).clone(
            depth=VIT_DEPTH),
        batch["rgbs"][0], seed=9)
    ref = jax_encode(jmodel, params, jprep)
    model = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        out = model.encode_prepared(tda.prepare_inputs(batch, BOUNDS, tcfg, device="cpu"))
    assert out["context_feats"].shape == (2, 2 * 4 + n_vertices, 24)
    assert_bf16_close(out["context_feats"].numpy(), ref["context_feats"], "context_feats")
    np.testing.assert_allclose(out["context"].numpy(), np.asarray(ref["context"]),
                               atol=FEATURE_ATOL, rtol=0)
    np.testing.assert_array_equal(out["context_mask"].numpy(), np.asarray(ref["context_mask"]))


# ------------------------------------------------------------------ weights


def test_converters_match_jax():
    """The port's numpy converters give the JAX package's trees exactly."""
    rng = np.random.default_rng(14)
    E, depth, heads, grid = 32, 2, 4, 3

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {"patch_embed.proj.weight": n(E, 3, 4, 4), "patch_embed.proj.bias": n(E),
          "pos_embed": n(1, 1 + grid * grid, E), "cls_token": n(1, 1, E),
          "norm.weight": n(E), "norm.bias": n(E)}
    for i in range(depth):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": n(E), b + "norm1.bias": n(E),
                   b + "norm2.weight": n(E), b + "norm2.bias": n(E),
                   b + "ls1.gamma": n(E), b + "ls2.gamma": n(E),
                   b + "attn.qkv.weight": n(3 * E, E), b + "attn.qkv.bias": n(3 * E),
                   b + "attn.proj.weight": n(E, E), b + "attn.proj.bias": n(E),
                   b + "mlp.fc1.weight": n(4 * E, E), b + "mlp.fc1.bias": n(4 * E),
                   b + "mlp.fc2.weight": n(E, 4 * E), b + "mlp.fc2.bias": n(E)})
    radio = {("radio_model." + k if k.startswith(("blocks.", "norm.")) else k): v
             for k, v in sd.items() if not k.startswith(("patch_embed", "pos_embed", "cls"))}
    radio.update({"patch_generator.embedder.weight": n(E, 3 * 4 * 4),
                  "patch_generator.pos_embed": n(1, grid * grid, E),
                  "patch_generator.cls_token.token": n(2, E),
                  "input_conditioner.norm_mean": n(3, 1, 1),
                  "input_conditioner.norm_std": n(3, 1, 1)})

    def same(a, b):
        flat_a = dict(jax.tree_util.tree_flatten_with_path(a)[0])
        flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
        assert flat_a.keys() == flat_b.keys()
        for key in flat_a:
            np.testing.assert_array_equal(flat_a[key], flat_b[key], err_msg=str(key))

    same(twc.convert_torch_vit_weights(sd, depth, heads),
         jwc.convert_torch_vit_weights(sd, depth, heads))
    same(twc.convert_radio_vit_weights(radio, depth, heads),
         jwc.convert_radio_vit_weights(radio, depth, heads))
    params = twc.convert_torch_vit_weights(sd, depth, heads)
    for target in (grid, 5, 2):
        np.testing.assert_allclose(
            twc.interpolate_pos_embed(params, target)["pos_embed"],
            np.asarray(jwc.interpolate_pos_embed(params, target)["pos_embed"]),
            atol=1e-6, rtol=0)
    grafted = twc.graft_subtree({"a": {"b": {"c": 1}, "d": 2}}, "a/b", {"x": 3})
    assert grafted == jwc.graft_subtree({"a": {"b": {"c": 1}, "d": 2}}, "a/b", {"x": 3})
    with pytest.raises(KeyError, match="missing"):
        twc.graft_subtree({"a": {}}, "a/missing", {})


def test_npz_round_trip_between_packages(fast_tmp_path):
    tree = {"params": {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
                       "b": np.ones((4,), np.float32)}, "norm_mean": np.zeros(3, np.float32)}
    for save, load in ((twc.save_variables_npz, jwc.load_variables_npz),
                       (jwc.save_variables_npz, twc.load_variables_npz),
                       (twc.save_variables_npz, twc.load_variables_npz)):
        path = str(fast_tmp_path / f"{save.__module__.split('.')[0]}.npz")
        save(path, tree)
        loaded = load(path)
        assert loaded.keys() == tree.keys()
        np.testing.assert_array_equal(loaded["params"]["a"]["kernel"],
                                      tree["params"]["a"]["kernel"])
        np.testing.assert_array_equal(loaded["params"]["b"], tree["params"]["b"])


@pytest.fixture
def radio_npz(fast_tmp_path):
    """A random depth-2 RADIO-geometry tree with its own input
    normalization, written by the JAX package's ``save_variables_npz``."""
    rgb = np.random.default_rng(15).uniform(size=(2, 40, 40, 3)).astype(np.float32)
    mean_std = ((0.4, 0.5, 0.6), (0.2, 0.3, 0.25))
    params = random_vit_params(jax_vit("radio_v25_b", (2, 2), mean_std=mean_std), rgb, seed=16)
    path = str(fast_tmp_path / "radio.npz")
    jwc.save_variables_npz(path, {"params": params, "norm_mean": np.asarray(mean_std[0]),
                                  "norm_std": np.asarray(mean_std[1])})
    return path, rgb


def test_pretrained_backbone_matches_jax(depth2_backbones, radio_npz):
    path, rgb = radio_npz
    jmodule, jparams = jpre.build_backbone("radio_v25_b", path, (2, 2))
    ref = jax.jit(jmodule.apply)({"params": jparams}, jnp.asarray(rgb))
    module = tpre.build_backbone("radio_v25_b", path, (2, 2), device="cpu")
    assert module.num_prefix_tokens == 1
    torch.testing.assert_close(module.mean, torch.tensor([0.4, 0.5, 0.6]))
    assert_bf16_close(module(torch.from_numpy(rgb)).numpy(), ref, "build_backbone")

    # Into a policy: the registry normalization stays, the weights load.
    _, tcfg = image_configs("rgbd", feature_type="radio_v25_b", feature_image_size=(2, 2),
                            **SMALL)
    model = tda.DiffuserActor(tcfg, device="cpu")
    tpre.load_backbone_into_model(model, "radio_v25_b", path)
    jref = jax.jit(jax_vit("radio_v25_b", (2, 2)).apply)({"params": jparams}, jnp.asarray(rgb))
    assert_bf16_close(model.encoder.feature_extractor(torch.from_numpy(rgb)).numpy(), jref,
                      "load_backbone_into_model")


def test_pretrained_prefix_token_mismatch_raises(depth2_backbones, radio_npz):
    path, _ = radio_npz
    _, tcfg = image_configs("rgbd", feature_type="radio_v25_b", feature_image_size=(2, 2),
                            feature_num_prefix_tokens=0, **SMALL)
    model = tda.DiffuserActor(tcfg, device="cpu")
    with pytest.raises(ValueError, match="feature_num_prefix_tokens=1"):
        tpre.load_backbone_into_model(model, "radio_v25_b", path)
    with pytest.raises(ValueError, match="pretrained weights"):
        tpre.require_backbone_weights("dino_v2_vits14", None, "a test")
    tpre.require_backbone_weights("rgb", None, "a test")


def test_rgbd_fixture_loads_strictly_into_rgbd_model_only():
    params = load_params("spatial_memory/rgbd_last.ckpt")
    _, tcfg = image_configs("rgbd", feature_image_size=(16, 16), embedding_dim=72,
                            num_attn_heads=8, fps_subsampling_factor=4)
    model = tda.DiffuserActor(tcfg, device="cpu")
    load_flax_params(model, params)
    assert model.encoder.image_feature_encoder.weight.shape == (72, 3)
    assert not hasattr(model.encoder, "reconstruction_encoder")
    _, both = image_configs("rgbd_and_mesh", feature_image_size=(16, 16), embedding_dim=72,
                            num_attn_heads=8, fps_subsampling_factor=4)
    with pytest.raises(KeyError, match="reconstruction_encoder"):
        load_flax_params(tda.DiffuserActor(both, device="cpu"), params)
