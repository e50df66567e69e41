"""Torch port vs the JAX package: the map's triangle mesh and dense views.

Surface Nets on the host (``mapping/surface_nets.py``) and on the map's
device (``voxel_grid.extract_surface_mesh_device``), the dense layer views
(``query_{features,colors,tsdf}_dense``, ``get_voxel_center_grids``) and
``Mapper.update_color_mesh`` with both backends, at the small config of
``tests/test_surface_nets.py`` (2 cm voxels, a 1 m box, 64x64 frames, a
noisy wall at 1 m, 4-d features).

Both packages read one map: the JAX mapper integrates it and the port takes
its state through numpy (``state_from_numpy``). Maps integrated apart differ
in their vertex counts (ROADMAP.md section 3, the truncation boundary).

Tolerances: every output of both Surface Nets passes, the dense views and
the color mesh equal the JAX package's exactly (the device pass sums each
vertex's crossings in JAX's order in fp32 and rounds its final
``origin + (c + 0.5) * voxel`` once, as XLA's fused multiply-add does).
Within the port, device against host: JAX's own bars
(``tests/test_surface_nets.py:87-134``): vertices within 1e-5 (the host sums
in float64), colors within 1e-6, triangle sets equal.
"""
import logging

import numpy as np
import pytest
import torch

from nvblox_mindmap_tpu.mapping import mapper as jmapper
from nvblox_mindmap_tpu.mapping import surface_nets as jsn
from nvblox_mindmap_tpu.mapping import voxel_grid as jvg
from nvblox_mindmap_tpu.mapping.constants import MapperId
from nvblox_mindmap_tpu.mapping.constants import MappingConfig as JaxConfig
from nvblox_mindmap_torch.mapping import mapper as tmapper
from nvblox_mindmap_torch.mapping import surface_nets as tsn
from nvblox_mindmap_torch.mapping import voxel_grid as tvg
from nvblox_mindmap_torch.mapping.constants import MappingConfig
from tests.test_surface_nets import sphere_sdf

DEVICE_HOST_VERTEX_ATOL = 1e-5
DEVICE_HOST_COLOR_ATOL = 1e-6
H = W = 64
SMALL = dict(voxel_size_m=0.02, aabb_min_m=(-0.5, -0.5, 0.5), aabb_max_m=(0.5, 0.5, 1.5),
             feature_dim=4, max_feature_pages=256, valid_depth_mask_erosion_iterations=1,
             static_mask_erosion_iterations=1)
K = np.asarray([[64.0, 0, W / 2], [0, 64.0, H / 2], [0, 0, 1]], np.float32)
T = np.eye(4, dtype=np.float32)


def jax_mapper(seed=0, features=True, depth_only=False):
    """The JAX mapper over one frame of a noisy wall at 1 m (color and 4-d
    features split left / right), and its config."""
    cfg = JaxConfig(**SMALL)
    mapper = jmapper.Mapper({MapperId.STATIC: cfg})
    rng = np.random.default_rng(seed)
    depth = (1.0 + 0.03 * rng.standard_normal((H, W))).astype(np.float32)
    mapper.add_depth_frame(depth, T, K)
    if not depth_only:
        rgb = rng.uniform(0.2, 0.9, (H, W, 3)).astype(np.float32)
        mapper.add_color_frame(rgb, T, K)
    if features and not depth_only:
        feats = np.zeros((H, W, 4), np.float32)
        feats[:, : W // 2, 0] = 1.0
        feats[:, W // 2:, 1] = rng.uniform(0.5, 1.0, (H, W // 2))
        mapper.add_feature_frame(feats, T, K)
    return mapper, cfg


def port_copy(jmap, jcfg):
    """The port's mapper (CPU) holding the JAX mapper's state."""
    cfg = MappingConfig(**SMALL)
    assert dataclass_fields(cfg) == dataclass_fields(jcfg)
    mapper = tmapper.Mapper({MapperId.STATIC: cfg}, device="cpu")
    mapper.states[MapperId.STATIC] = tvg.state_from_numpy(
        tvg.state_to_numpy(jmap.states[MapperId.STATIC]), "cpu")
    return mapper, cfg


def dataclass_fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def tri_set(triangles):
    return set(map(tuple, np.sort(np.asarray(triangles), axis=1)))


def planes(axis, n=12):
    """A TSDF rising along ``axis`` (a plane between voxels 5 and 6)."""
    coord = np.arange(n, dtype=np.float32)
    shape = [1, 1, 1]
    shape[axis] = n
    tsdf = np.broadcast_to((coord - 5.6).reshape(shape) * 0.01, (n, n, n)).copy()
    return tsdf, np.ones((n, n, n), np.float32)


@pytest.mark.parametrize("case", ["sphere", "sphere_half_observed", "plane_x", "plane_y",
                                  "plane_z", "mapped_wall", "empty"])
def test_host_surface_nets_equals_jax(case):
    """The port's copy of ``surface_nets`` gives the JAX package's mesh, bit
    for bit, on the same TSDF and weights."""
    voxel, origin, truncation = 0.03125, np.full(3, -0.5), None
    if case.startswith("sphere"):
        tsdf = sphere_sdf()
        weight = np.ones_like(tsdf)
        if case == "sphere_half_observed":
            weight[:, :, : tsdf.shape[2] // 2] = 0
    elif case.startswith("plane"):
        tsdf, weight = planes("xyz".index(case[-1]))
        voxel, origin, truncation = 0.01, np.zeros(3), 0.04
    elif case == "mapped_wall":
        jmap, cfg = jax_mapper()
        state = tvg.state_to_numpy(jmap.states[MapperId.STATIC])
        tsdf, weight = state["tsdf"], state["weight"]
        voxel, origin = cfg.voxel_size_m, np.asarray(cfg.aabb_min_m, np.float64)
        truncation = cfg.truncation_distance_m
    else:
        tsdf, weight = np.full((6, 6, 6), 0.1, np.float32), np.ones((6, 6, 6), np.float32)
    jout = jsn.surface_nets(tsdf, weight, voxel, origin, truncation=truncation)
    tout = tsn.surface_nets(tsdf, weight, voxel, origin, truncation=truncation)
    for j, t in zip(jout, tout):
        assert j.dtype == t.dtype and np.array_equal(j, t)
    if case != "empty":
        assert len(tout[1]) > 10


@pytest.mark.parametrize("budget", ["fits", "overflows"])
def test_device_surface_nets_equals_jax(budget):
    """All seven outputs of the device pass equal JAX's, dtypes included;
    with budgets of 8 / 8 (``tests/test_surface_nets.py:137``) the counts
    report the overflow in both."""
    jmap, jcfg = jax_mapper(depth_only=budget == "overflows")
    tmap, tcfg = port_copy(jmap, jcfg)
    budgets = (65536, 262144) if budget == "fits" else (8, 8)
    jout = jvg.extract_surface_mesh_device(jmap.states[MapperId.STATIC], jcfg, *budgets)
    tout = tvg.extract_surface_mesh_device(tmap.states[MapperId.STATIC], tcfg, *budgets)
    names = ("vertices", "vertex_valid", "cells", "triangles", "tri_valid", "n_vertices",
             "n_triangles")
    for name, j, t in zip(names, jout, tout):
        j = np.asarray(j)
        assert isinstance(t, torch.Tensor), name
        t = t.numpy()
        assert (t.dtype, t.shape) == (j.dtype, j.shape), name
        assert np.array_equal(t, j), name
    n_vertices, n_triangles = int(tout[5]), int(tout[6])
    if budget == "overflows":
        assert n_vertices > 8 and int(tout[1].sum()) == 8 and int(tout[4].sum()) <= 8
    else:
        assert 50 < n_vertices <= budgets[0] and 50 < n_triangles <= budgets[1]


@pytest.mark.parametrize("view", ["features", "colors", "tsdf", "centers"])
def test_dense_views_equal_jax(view):
    jmap, jcfg = jax_mapper()
    tmap, tcfg = port_copy(jmap, jcfg)
    jstate, tstate = jmap.states[MapperId.STATIC], tmap.states[MapperId.STATIC]
    if view == "centers":
        j = jvg.get_voxel_center_grids(jcfg)
        t = tvg.get_voxel_center_grids(tcfg, "cpu")
    else:
        j = getattr(jvg, f"query_{view}_dense")(jstate, jcfg)
        t = getattr(tvg, f"query_{view}_dense")(tstate, tcfg)
        # And through the mapper's layer views.
        assert torch.equal(getattr(tmap, f"{view}_dense")(), t)
    j = np.asarray(j)
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    assert np.array_equal(t.numpy(), j)
    if view in ("features", "colors"):
        assert (t != 0).any() and (t == 0).any()  # allocated and unallocated voxels
    assert np.array_equal(tmap.weight_dense().numpy(), np.asarray(jmap.weight_dense()))


@pytest.mark.parametrize("backend", ["device", "host"])
def test_color_mesh_equals_jax(backend):
    jmap, jcfg = jax_mapper()
    tmap, _ = port_copy(jmap, jcfg)
    jmap.update_color_mesh(MapperId.STATIC, backend=backend)
    tmap.update_color_mesh(MapperId.STATIC, backend=backend)
    for j, t in zip(jmap.get_color_mesh(), tmap.get_color_mesh()):
        j = np.asarray(j)
        assert isinstance(t, np.ndarray) and t.dtype == j.dtype and np.array_equal(t, j)
    vertices, triangles, colors = tmap.get_color_mesh()
    assert len(vertices) > 50 and len(triangles) > 50 and (colors > 0).any()


def test_port_device_mesh_matches_host_mesh():
    """Within the port, the JAX test's bars between the backends."""
    jmap, jcfg = jax_mapper()
    tmap, _ = port_copy(jmap, jcfg)
    tmap.update_color_mesh(MapperId.STATIC, backend="host")
    hv, ht, hc = tmap.get_color_mesh()
    tmap.update_color_mesh(MapperId.STATIC, backend="device")
    dv, dt, dc = tmap.get_color_mesh()
    assert len(dv) == len(hv) > 50 and len(dt) == len(ht) > 50
    np.testing.assert_allclose(dv, hv, atol=DEVICE_HOST_VERTEX_ATOL)
    np.testing.assert_allclose(dc, hc, atol=DEVICE_HOST_COLOR_ATOL)
    assert dt.min() >= 0 and dt.max() < len(dv)
    assert tri_set(dt) == tri_set(ht)


def test_color_mesh_cache_is_one_per_mapper_and_overflow_warns(caplog):
    """The JAX package's cache: one attribute for the mapper (not per map
    id), kept by ``clear``; ``get_color_mesh`` extracts on demand; an
    overflowing budget warns under the port's logger; a backend name
    outside the two raises."""
    jmap, jcfg = jax_mapper()
    tmap, _ = port_copy(jmap, jcfg)
    first = tmap.get_color_mesh()
    assert first is tmap.get_color_mesh()
    tmap.clear()
    assert tmap.get_color_mesh() is first
    with caplog.at_level(logging.WARNING, logger="nvblox_mindmap_torch.mapping"):
        tmap2, _ = port_copy(jmap, jcfg)
        tmap2.update_color_mesh(max_vertices=8, max_triangles=8)
    assert any("color-mesh budget overflow" in r.getMessage() and r.name ==
               "nvblox_mindmap_torch.mapping" for r in caplog.records)
    vertices, triangles, colors = tmap2.get_color_mesh()
    assert len(vertices) == 8 and len(colors) == 8 and len(triangles) <= 8
    with pytest.raises(ValueError, match="backend"):
        tmap2.update_color_mesh(backend="gpu")


def test_save_mesh_ply_equals_jax(tmp_path):
    jmap, jcfg = jax_mapper()
    jmap.update_color_mesh(MapperId.STATIC, backend="host")
    vertices, triangles, colors = jmap.get_color_mesh()
    for with_colors in (True, False):
        c = colors if with_colors else None
        jsn.save_mesh_ply(str(tmp_path / "j.ply"), vertices, triangles, c)
        tsn.save_mesh_ply(str(tmp_path / "t.ply"), vertices, triangles, c)
        assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


def test_device_mesh_winding_is_consistent():
    """On planes along each axis the device mesh's faces all point to the
    negative-TSDF side (the y-axis quads' frame is left-handed), as the host
    pass's do (``tests/test_surface_nets.py:168``)."""
    for axis in range(3):
        tsdf, weight = planes(axis)
        n = tsdf.shape[0]
        cfg = MappingConfig(voxel_size_m=0.01, aabb_min_m=(0.0, 0.0, 0.0),
                            aabb_max_m=(0.12, 0.12, 0.12), feature_dim=1, max_feature_pages=1)
        assert cfg.truncation_distance_m == 0.04
        X, Y, Z = cfg.grid_shape  # 16^3: the planes' 12^3 in a corner, the rest unobserved
        full_t = np.full((X, Y, Z), 1.0, np.float32)
        full_w = np.zeros((X, Y, Z), np.float32)
        full_t[:n, :n, :n], full_w[:n, :n, :n] = tsdf, weight
        state = tvg.create_state(cfg, "cpu")
        state.tsdf, state.weight = torch.from_numpy(full_t), torch.from_numpy(full_w)
        v, vv, _, t, tv, _, _ = tvg.extract_surface_mesh_device(state, cfg, 4096, 16384)
        v, t = v[vv].numpy(), t[tv].numpy()
        normals = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])[:, axis]
        nonzero = np.abs(normals) > 1e-12
        assert nonzero.any() and (normals[nonzero] < 0).all(), axis
        hv, ht, _ = tsn.surface_nets(full_t, full_w, cfg.voxel_size_m,
                                     np.zeros(3), truncation=0.04)
        assert tri_set(t) == tri_set(ht)
        np.testing.assert_allclose(v, hv, atol=DEVICE_HOST_VERTEX_ATOL)
