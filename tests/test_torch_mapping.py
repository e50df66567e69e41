"""Torch port vs the JAX package: live mapping (voxel grid, mapper recipe,
back-projection, the mapping feature functions).

Both packages start from the same state (``state_from_numpy``) and take the
same numpy frames: a camera with a rotated, translated pose over a depth
image of smooth relief with invalid pixels (zeros, NaN), at 0.02 m voxels,
64x64 frames and 8-d features, as ``tests/test_mapping.py`` sizes them.

Tolerances:
- page tables, page-to-block maps and page counts: exact;
- ``tsdf`` / ``weight`` / pool weights within 1e-5 and the fp16 pools within
  1e-3, on all but ``MAX_TIE_SHARE`` (0.1%) of the entries: a voxel centre on
  a half-pixel tie may round to the neighbouring pixel when the two
  packages sum the projection in another order; each test prints how many
  entries differed;
- surface vertices and features within 1e-5, crossing counts exact, when
  both packages extract from the same map. From maps each package
  integrated itself, vertices stay within 1e-5 but features are held to
  the pools' 1e-3: XLA's CPU dot fuses the projection's products into
  FMAs, so z and the TSDF differ by ~1e-7, and at a crossing whose two
  TSDF endpoints are both near zero that moves the blend weight by up to
  ~1e-3 (measured: 7.5e-4 on 6% of the vertices after three frames);
- back-projection within 1e-5 (fp32, the inverse intrinsics by another
  library); the RGB feature function 1e-6; the ViT feature function to the
  bf16 bound of ``tests/test_torch_image_path.py``.
"""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvblox_mindmap_tpu.mapping import constants as jconst
from nvblox_mindmap_tpu.mapping import mapper as jmapper
from nvblox_mindmap_tpu.mapping import voxel_grid as jvg
from nvblox_mindmap_tpu.models import pretrained as jpre
from nvblox_mindmap_tpu.ops import backprojection as jbp
from nvblox_mindmap_torch.mapping import constants as tconst
from nvblox_mindmap_torch.mapping import mapper as tmapper
from nvblox_mindmap_torch.mapping import voxel_grid as tvg
from nvblox_mindmap_torch.models import pretrained as tpre
from nvblox_mindmap_torch.ops import backprojection as tbp
from tests.test_torch_image_path import (  # noqa: F401 (pytest fixtures)
    assert_bf16_close,
    depth2_backbones,
    radio_npz,
)
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)

MAX_TIE_SHARE = 1e-3
FP32_ATOL = 1e-5
POOL_ATOL = 1e-3
H = W = 64
FEATURES = 8


def jconfig(feature_dim=FEATURES, **fields):
    base = dict(voxel_size_m=0.02, aabb_min_m=(-0.5, -0.5, 0.5), aabb_max_m=(0.5, 0.5, 1.5),
                tsdf_decay_factor=0.98, min_integration_distance_m=0.1,
                feature_dim=feature_dim, max_feature_pages=512,
                valid_depth_mask_erosion_iterations=1, static_mask_erosion_iterations=1,
                dynamic_mask_erosion_iterations=1, dynamic_class_labels=("robot",),
                upscaled_feature_image_size=(H, H))
    base.update(fields)
    return jconst.MappingConfig(**base)


def tconfig(jcfg):
    return tconst.MappingConfig(**dataclasses.asdict(jcfg))


def look_at(eye, target):
    """Camera-to-world (4, 4): +z toward ``target``, +x right, +y down."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, -1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.stack([x, y, z], axis=1)
    T[:3, 3] = eye
    return T


def frame(seed, size=H, feature_dim=FEATURES, holes=True):
    """(depth, T_WC, K, features, rgb): smooth relief ~1 m from a camera that
    looks at the box centre from a seeded offset."""
    rng = np.random.default_rng(seed)
    f = 0.9 * size
    K = np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    eye = np.asarray([0.0, 0.0, -0.05]) + rng.uniform(-0.08, 0.08, 3)
    T = look_at(eye, [0.02, -0.03, 1.0])
    vv, uu = np.mgrid[0:size, 0:size] / size
    depth = (1.02 + 0.12 * np.sin(6.0 * uu + rng.uniform(0, 6)) * np.cos(4.0 * vv)
             + 0.08 * vv + rng.normal(0, 0.003, (size, size))).astype(np.float32)
    if holes:
        depth[rng.uniform(size=(size, size)) < 0.05] = 0.0
        depth[3, 5] = np.nan
    features = rng.normal(size=(size, size, feature_dim)).astype(np.float32)
    rgb = rng.uniform(size=(size, size, 3)).astype(np.float32)
    return depth, T, K, features, rgb


def both_states(jcfg, jstate=None):
    """(JAX state, port state) equal to ``jstate`` (default: empty)."""
    jstate = jvg.create_state(jcfg) if jstate is None else jstate
    return jstate, tvg.state_from_numpy(tvg.state_to_numpy(jstate), device="cpu")


def assert_states_match(tstate, jstate, what=""):
    """Exact page bookkeeping; fp32 fields within FP32_ATOL and fp16 pools
    within POOL_ATOL on all but MAX_TIE_SHARE of their entries."""
    t, j = tvg.state_to_numpy(tstate), tvg.state_to_numpy(jstate)
    for name in ("page_table", "page_to_block", "num_pages"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=f"{what} {name}")
    report = {}
    for name, atol in (("tsdf", FP32_ATOL), ("weight", FP32_ATOL),
                       ("feat_weight", FP32_ATOL), ("color_weight", FP32_ATOL),
                       ("feat", POOL_ATOL), ("color", POOL_ATOL)):
        a, b = t[name].astype(np.float32), j[name].astype(np.float32)
        assert a.shape == b.shape and t[name].dtype == j[name].dtype, name
        off = ~np.isclose(a, b, atol=atol, rtol=0)
        report[name] = int(off.sum())
        assert off.mean() <= MAX_TIE_SHARE, (what, name, int(off.sum()), off.size)
    print(f"{what}: entries beyond tolerance {report}")
    return report


def jnp_args(depth, T, K, mask=None):
    return (jnp.asarray(depth), jnp.asarray(T), jnp.asarray(K),
            None if mask is None else jnp.asarray(mask))


def torch_args(depth, T, K, mask=None):
    return (torch.from_numpy(depth), torch.from_numpy(T), torch.from_numpy(K),
            None if mask is None else torch.from_numpy(mask))


def fused_pair(jcfg, n_frames, seed=0, with_features=True):
    """A mid-episode JAX map from ``n_frames`` fused frames (decay + depth +
    features), and the port's copy of it."""
    jstate = jvg.create_state(jcfg)
    for i in range(n_frames):
        depth, T, K, feats, _ = frame(seed + i, feature_dim=jcfg.feature_dim)
        jstate = jvg.integrate_depth(jstate, jcfg, *jnp_args(depth, T, K))
        if with_features:
            jstate = jvg.integrate_features(jstate, jcfg, jnp.asarray(feats, jnp.float16),
                                            jnp.asarray(T), jnp.asarray(K))
    return both_states(jcfg, jstate)


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("task", [t.value for t in jconst.Tasks])
def test_mapping_config_matches_jax(task):
    jtask = jconst.Tasks(task)
    for kw in ({}, dict(feature_dim=3, voxel_size_m=0.02, max_feature_pages=512),
               dict(projective_appearance_integrator_measurement_weight=0.5)):
        jcfg = jconst.MappingConfig.for_task(jtask, **kw)
        tcfg = tconst.MappingConfig.for_task(task, **kw)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for size in ((64, 64), (512, 512), (128, 96)):
            assert (dataclasses.asdict(tcfg.scaled_for_image_size(size))
                    == dataclasses.asdict(jcfg.scaled_for_image_size(size)))
        assert tcfg.grid_shape == jcfg.grid_shape
        assert tcfg.block_grid_shape == jcfg.block_grid_shape
        assert tcfg.truncation_distance_m == jcfg.truncation_distance_m
    np.testing.assert_array_equal(tconst.get_workspace_bounds(task),
                                  jconst.get_workspace_bounds(jtask))
    assert tconst.COMMON_NVBLOX_MAPPER_CFG == jconst.COMMON_NVBLOX_MAPPER_CFG
    assert (tconst.MapperId.STATIC, tconst.MapperId.DYNAMIC) == (jconst.MapperId.STATIC,
                                                                 jconst.MapperId.DYNAMIC)


def test_state_round_trip_and_centers():
    jcfg = jconfig()
    jstate, tstate = fused_pair(jcfg, 1)
    assert_states_match(tstate, jstate, "round trip")
    assert tstate.feat.dtype == torch.float16 and tstate.page_table.dtype == torch.int32
    np.testing.assert_array_equal(tvg.voxel_centers_flat(tconfig(jcfg)).numpy(),
                                  np.asarray(jvg.voxel_centers_flat(jcfg)))
    fresh = tvg.create_state(tconfig(jcfg), device="cpu")
    assert_states_match(fresh, jvg.create_state(jcfg), "create_state")


# ------------------------------------------------------------------ integrators


@pytest.mark.parametrize("masked", [False, True])
def test_integrate_depth_matches_jax(masked):
    jcfg = jconfig()
    jstate, tstate = fused_pair(jcfg, 1)  # a second frame over a first
    depth, T, K, _, _ = frame(7)
    mask = None
    if masked:
        mask = np.random.default_rng(8).uniform(size=depth.shape) > 0.3
    ref = jvg.integrate_depth(jstate, jcfg, *jnp_args(depth, T, K, mask))
    out = tvg.integrate_depth(tstate, tconfig(jcfg), *torch_args(depth, T, K, mask))
    assert_states_match(out, ref, f"integrate_depth masked={masked}")
    assert 0 < float((out.weight > 0).float().mean()) < 0.5


def test_decay_matches_jax():
    jcfg = jconfig(tsdf_decay_factor=0.5)  # a few decays kill weights
    jstate, tstate = fused_pair(jcfg, 2)
    tcfg = tconfig(jcfg)
    for i in range(4):
        jstate = jvg.decay(jstate, jcfg)
        tstate = tvg.decay(tstate, tcfg)
        assert_states_match(tstate, jstate, f"decay {i}")
    assert float(tstate.weight.max()) > 0 and int((tstate.feat_weight == 0).sum()) > 0


@pytest.mark.parametrize("case", ["allocate", "reclaim_after_decay", "exhausted_pool"])
def test_allocate_pages_matches_jax(case):
    fields = {"exhausted_pool": dict(max_feature_pages=24),
              "reclaim_after_decay": dict(tsdf_decay_factor=0.3)}.get(case, {})
    jcfg = jconfig(**fields)
    tcfg = tconfig(jcfg)
    jstate, tstate = fused_pair(jcfg, 1)
    if case == "reclaim_after_decay":
        for _ in range(5):  # every weight decays to zero: every page frees
            jstate, tstate = jvg.decay(jstate, jcfg), tvg.decay(tstate, tcfg)
        assert int(tstate.num_pages) > 0
    depth, T, K, _, _ = frame(11)
    jstate = jvg.integrate_depth(jstate, jcfg, *jnp_args(depth, T, K))
    tstate = tvg.integrate_depth(tstate, tcfg, *torch_args(depth, T, K))
    ref = jvg.allocate_pages(jstate, jcfg)
    out = tvg.allocate_pages(tstate, tcfg)
    assert_states_match(out, ref, f"allocate {case}")
    pages = out.page_to_block.numpy()
    table = out.page_table.numpy().reshape(-1)
    live = pages[pages >= 0]
    assert len(set(live.tolist())) == len(live)  # one page per block
    np.testing.assert_array_equal(table[live], np.nonzero(pages >= 0)[0])
    if case == "exhausted_pool":
        assert int(out.num_pages) == jcfg.max_feature_pages
    if case == "reclaim_after_decay":
        # Reclaimed pages go back to the free list and are handed out again.
        assert int(out.num_pages) > 0
        assert (out.feat_weight[pages < 0] == 0).all()


@pytest.mark.parametrize("pool", ["features", "color"])
def test_pool_integration_matches_jax(pool):
    jcfg = jconfig()
    jstate, tstate = fused_pair(jcfg, 2)
    depth, T, K, feats, rgb = frame(13)
    mask = np.random.default_rng(14).uniform(size=depth.shape) > 0.2
    if pool == "features":
        ref = jvg.integrate_features(jstate, jcfg, jnp.asarray(feats, jnp.float16),
                                     jnp.asarray(T), jnp.asarray(K), jnp.asarray(mask))
        out = tvg.integrate_features(tstate, tconfig(jcfg),
                                     torch.from_numpy(feats).half(), torch.from_numpy(T),
                                     torch.from_numpy(K), torch.from_numpy(mask))
        assert int((out.feat_weight > 0).sum()) > 1000
    else:
        ref = jvg.integrate_color(jstate, jcfg, jnp.asarray(rgb), jnp.asarray(T),
                                  jnp.asarray(K), jnp.asarray(mask))
        out = tvg.integrate_color(tstate, tconfig(jcfg), torch.from_numpy(rgb),
                                  torch.from_numpy(T), torch.from_numpy(K),
                                  torch.from_numpy(mask))
        assert int((out.color_weight > 0).sum()) > 1000
    assert_states_match(out, ref, f"integrate {pool}")


@pytest.mark.parametrize("with_decay,masked", [(True, True), (False, False)])
def test_fuse_frame_matches_jax_and_sequential(with_decay, masked):
    jcfg = jconfig()
    tcfg = tconfig(jcfg)
    jstate, tstate = fused_pair(jcfg, 2)
    depth, T, K, feats, _ = frame(17)
    feats16 = feats.astype(np.float16)
    fK = K.copy()
    dmask = fmask = None
    if masked:
        rng = np.random.default_rng(18)
        dmask = rng.uniform(size=depth.shape) > 0.2
        fmask = rng.uniform(size=depth.shape) > 0.2
    ref = jvg.fuse_frame(jstate, jcfg, jnp.asarray(depth), jnp.asarray(feats16),
                         jnp.asarray(T), jnp.asarray(K), jnp.asarray(fK),
                         depth_mask=None if dmask is None else jnp.asarray(dmask),
                         with_decay=with_decay,
                         feature_mask=None if fmask is None else jnp.asarray(fmask))
    out = tvg.fuse_frame(tstate, tcfg, torch.from_numpy(depth), torch.from_numpy(feats16),
                         torch.from_numpy(T), torch.from_numpy(K), torch.from_numpy(fK),
                         depth_mask=None if dmask is None else torch.from_numpy(dmask),
                         with_decay=with_decay,
                         feature_mask=None if fmask is None else torch.from_numpy(fmask))
    assert_states_match(out, ref, f"fuse_frame decay={with_decay} masked={masked}")

    seq = tvg.decay(tstate, tcfg) if with_decay else tstate
    seq = tvg.integrate_depth(seq, tcfg, *torch_args(depth, T, K, dmask))
    seq = tvg.integrate_features(seq, tcfg, torch.from_numpy(feats16), torch.from_numpy(T),
                                 torch.from_numpy(fK),
                                 None if fmask is None else torch.from_numpy(fmask))
    for name, value in tvg.state_to_numpy(out).items():
        np.testing.assert_array_equal(value, tvg.state_to_numpy(seq)[name], err_msg=name)
    with pytest.raises(ValueError, match="feature_mask"):
        tvg.fuse_frame(tstate, tcfg, torch.from_numpy(depth), torch.from_numpy(feats16),
                       torch.from_numpy(T), torch.from_numpy(K), torch.from_numpy(fK),
                       feature_mask=torch.ones(8, 8, dtype=torch.bool))


# ------------------------------------------------------------------ extraction


@pytest.mark.parametrize("max_vertices", [65536, 500])
def test_extract_surface_vertices_matches_jax(max_vertices):
    """An ample budget, and one the surface overflows (truncation by voxel
    linear index)."""
    jcfg = jconfig()
    jstate, tstate = fused_pair(jcfg, 3)
    jv, jf, jvalid, jcount = jvg.extract_surface_vertices(jstate, jcfg, max_vertices,
                                                          return_count=True)
    tv, tf, tvalid, tcount = tvg.extract_surface_vertices(tstate, tconfig(jcfg), max_vertices,
                                                          return_count=True)
    assert int(tcount) == int(jcount) > 500
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=FP32_ATOL, rtol=0)
    assert int((tf.abs().sum(1) > 0).sum()) > 100


# ------------------------------------------------------------------ mapper recipe


def _robot_mask(seed, size=H):
    mask = np.zeros((size, size), bool)
    x0 = 8 + seed % 20
    mask[20:44, x0:x0 + 14] = True
    return mask


@pytest.mark.parametrize("include_dynamic", [False, True])
def test_nvblox_integrate_recipe_matches_jax(include_dynamic):
    """Depth, color and features per frame with dynamic masks, into the
    STATIC (and DYNAMIC) maps; then the feature mesh of each."""
    jcfg = jconfig()
    tcfg = tconfig(jcfg)
    jm = jmapper.Mapper.dual(jcfg) if include_dynamic else jmapper.Mapper({0: jcfg})
    tm = (tmapper.Mapper.dual(tcfg, device="cpu") if include_dynamic
          else tmapper.Mapper({0: tcfg}, device="cpu"))
    for i in range(3):
        depth, T, K, _, rgb = frame(20 + i)
        feats = np.random.default_rng(30 + i).normal(size=(2 * H, 2 * H, FEATURES))
        dmask = _robot_mask(i)
        jm.decay()
        tm.decay()
        jimages = jmapper.nvblox_integrate(jm, jcfg, depth, feats, K, T, rgb, dmask,
                                           include_dynamic)
        timages = tmapper.nvblox_integrate(tm, tcfg, depth, torch.from_numpy(feats), K, T,
                                           rgb, dmask, include_dynamic)
        assert sorted(timages) == sorted(jimages)
        for key in jimages:
            for name in ("depth_mask", "feature_mask"):
                np.testing.assert_array_equal(timages[key][name].numpy(),
                                              jimages[key][name], err_msg=f"{key} {name}")
    for mid in jm.states:
        assert_states_match(tm.states[mid], jm.states[mid], f"mapper {mid}")
        jv, jf = jmapper.get_vertices_and_features(jm, mid, remove_zero_features=True)
        tv, tf = tmapper.get_vertices_and_features(tm, mid, remove_zero_features=True)
        assert tm.last_crossing_count == jm.last_crossing_count
        assert tv.shape == jv.shape and tv.shape[0] > 50
        np.testing.assert_allclose(tv, jv, atol=FP32_ATOL, rtol=0)
        np.testing.assert_allclose(tf, jf, atol=POOL_ATOL, rtol=0)
    if include_dynamic:
        # The two maps hold separate tensors.
        static, dynamic = tm.states[0], tm.states[1]
        for f in dataclasses.fields(tvg.VoxelGridState):
            assert getattr(static, f.name).data_ptr() != getattr(dynamic, f.name).data_ptr()
    with pytest.raises(ValueError, match="segmentation"):
        tmapper.nvblox_integrate(tm, tcfg, depth, torch.from_numpy(feats), K, T, rgb, None,
                                 include_dynamic=True)


@pytest.mark.parametrize("remove_zero,excess", [(False, 0), (True, 0), (True, 3)])
def test_get_vertices_and_features_matches_jax(remove_zero, excess):
    jcfg = jconfig()
    jm = jmapper.Mapper({0: jcfg})
    tm = tmapper.Mapper({0: tconfig(jcfg)}, device="cpu")
    # Depth from two frames, features from one: some vertices stay featureless.
    for seed, with_features in ((40, True), (41, False)):
        depth, T, K, feats, _ = frame(seed)
        for m in (jm, tm):
            m.add_depth_frame(depth, T, K)
            if with_features:
                m.add_feature_frame(feats, T, K)
    jv, jf = jmapper.get_vertices_and_features(jm, remove_zero_features=remove_zero,
                                               num_excess_features=excess)
    tv, tf = tmapper.get_vertices_and_features(tm, remove_zero_features=remove_zero,
                                               num_excess_features=excess)
    assert isinstance(tv, np.ndarray) and tf.shape == jf.shape == (jv.shape[0], FEATURES - excess)
    np.testing.assert_allclose(tv, jv, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(tf, jf, atol=POOL_ATOL, rtol=0)
    if not remove_zero:
        assert (np.abs(tf).sum(1) == 0).any()


def test_mapper_overflow_warns_and_clears(caplog):
    tcfg = tconfig(jconfig())
    tm = tmapper.Mapper({0: tcfg}, device="cpu")
    depth, T, K, _, _ = frame(50)
    tm.add_depth_frame(depth, T, K)
    with caplog.at_level(logging.WARNING, logger="nvblox_mindmap_torch.mapping"):
        tm.update_feature_mesh(max_vertices=16)
    assert tm.last_crossing_count > 16 and "overflow" in caplog.text
    assert tm.get_feature_mesh()[0].shape == (16, 3)
    tm.clear()
    assert float(tm.states[0].weight.max()) == 0 and not tm._mesh_cache


# ------------------------------------------------------------------ back-projection


@pytest.mark.parametrize("batched", [False, True])
def test_get_camera_pointcloud_matches_jax(batched):
    rng = np.random.default_rng(60)
    B = 3
    depth = rng.uniform(0.3, 2.0, size=(B, 24, 32)).astype(np.float32)
    depth[0, 2, 3] = np.nan
    K = np.asarray([[30.0, 0, 16], [0, 28.0, 12], [0, 0, 1]], np.float32)
    intrinsics = np.repeat(K[None], B, 0) * rng.uniform(0.9, 1.1, (B, 1, 1)).astype(np.float32)
    intrinsics[:, 2] = [0, 0, 1]
    position = rng.normal(size=(B, 3)).astype(np.float32)
    quat = rng.normal(size=(B, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    args = (intrinsics, depth, position, quat)
    if not batched:
        args = tuple(a[0] for a in args)
    ref = jbp.get_camera_pointcloud(*(jnp.asarray(a) for a in args))
    out = tbp.get_camera_pointcloud(*(torch.from_numpy(a) for a in args))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL, rtol=1e-6)
    assert float(out.reshape(-1, 24, 32, 3)[0, 2, 3].abs().sum()) == 0.0


# ------------------------------------------------------------------ feature functions


def test_make_feature_fn_rgb_matches_jax():
    """Square cameras, as the mapper takes them: up, same size, down."""
    rgb = np.random.default_rng(70).uniform(size=(48, 48, 3))
    for size in ((96, 96), (48, 48), (16, 16)):
        ref = jpre.make_feature_fn("rgb", size)(rgb)
        out = tpre.make_feature_fn("rgb", size, device="cpu")(rgb)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_make_feature_fn_vit_matches_jax(depth2_backbones, radio_npz):
    """RADIO geometry at depth 2 from a converted checkpoint, 2x2 patches
    upscaled to 40x40x768."""
    path, rgb = radio_npz
    ref = jpre.make_feature_fn("radio_v25_b", (40, 40), path, (2, 2))(rgb[0])
    out = tpre.make_feature_fn("radio_v25_b", (40, 40), path, (2, 2), device="cpu")(rgb[0])
    assert out.shape == ref.shape == (40, 40, 768)
    assert_bf16_close(out.numpy(), ref, "make_feature_fn")
    with pytest.raises(ValueError, match="pretrained weights"):
        tpre.make_feature_fn("radio_v25_b", (40, 40), device="cpu")
