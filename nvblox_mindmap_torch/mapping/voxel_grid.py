"""TSDF + deep-feature voxel grid: functional state and its integrators.

Port of ``nvblox_mindmap_tpu/mapping/voxel_grid.py`` (the nvblox core; see
SURVEY.md section 2.2). The design is the JAX package's:

- The TSDF lives dense over the task box (a few million voxels at 1 cm).
  Integration is a gather: every voxel centre projects into the depth
  image and reads its pixel.
- Per-voxel deep features (e.g. 768-d) are too big dense, so they live in a
  block-paged pool mirroring nvblox's 8^3 voxel blocks: an int32 page table
  over the block grid plus a (P, 512, F) fp16 page pool. Pages go to blocks
  that hold near-surface voxels; allocation is a cumsum over the block grid.
- Every op is pure: state in, new state out.

The JAX package runs these as XLA programs (no Pallas kernel: they are
image gathers, ``voxel_grid.py:23-29`` there); here they are plain PyTorch
ops on the state's device. Two XLA idioms have no direct torch form:

- a scatter with ``mode="drop"`` that discards rows by writing them out of
  range: here the target gets one spare slot at its end, the discarded rows
  write there, and the slot is cut off (``_scatter_drop``);
- ``jnp.nonzero(size=, fill_value=)``, the first ``size`` set positions
  padded with a fill value: here a cumsum ranks the set positions and a
  scatter places them (``_nonzero_static``).

Neither synchronizes with the host. Nearest-pixel coordinates are clamped
in float before the cast to int (``_nearest_gather``): a voxel near the
camera plane projects to ~1e8 px, whose int32 cast torch leaves undefined.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.mapping.constants import MappingConfig


@dataclasses.dataclass
class VoxelGridState:
    """Mapper state: tensors on one device."""

    tsdf: torch.Tensor  # (X, Y, Z) f32, truncated signed distance
    weight: torch.Tensor  # (X, Y, Z) f32, 0 = unobserved
    page_table: torch.Tensor  # (BX, BY, BZ) i32, -1 = unallocated
    page_to_block: torch.Tensor  # (P,) i32 flat block index, -1 = free
    num_pages: torch.Tensor  # () i32
    feat: torch.Tensor  # (P, B^3, F) f16 weighted-average features
    feat_weight: torch.Tensor  # (P, B^3) f32
    color: torch.Tensor  # (P, B^3, 3) f16 rgb in [0,1]
    color_weight: torch.Tensor  # (P, B^3) f32

    @property
    def device(self) -> torch.device:
        return self.tsdf.device


def create_state(config: MappingConfig, device: DeviceLike = None) -> VoxelGridState:
    """An empty map on ``device`` (default ``cuda``; raises when CUDA is
    absent and no device is given)."""
    device = resolve_device(device)
    X, Y, Z = config.grid_shape
    BX, BY, BZ = config.block_grid_shape
    P = config.max_feature_pages
    B3 = config.block_size**3
    F = config.feature_dim

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return VoxelGridState(
        tsdf=full((X, Y, Z), config.truncation_distance_m, torch.float32),
        weight=full((X, Y, Z), 0.0, torch.float32),
        page_table=full((BX, BY, BZ), -1, torch.int32),
        page_to_block=full((P,), -1, torch.int32),
        num_pages=full((), 0, torch.int32),
        feat=full((P, B3, F), 0.0, torch.float16),
        feat_weight=full((P, B3), 0.0, torch.float32),
        color=full((P, B3, 3), 0.0, torch.float16),
        color_weight=full((P, B3), 0.0, torch.float32),
    )


def state_from_numpy(arrays, device: DeviceLike = None) -> VoxelGridState:
    """A state from host arrays keyed by field name (e.g. a JAX package
    state's leaves through ``np.asarray``), on ``device``."""
    device = resolve_device(device)
    return VoxelGridState(**{
        f.name: torch.from_numpy(np.array(_field(arrays, f.name))).to(device)
        for f in dataclasses.fields(VoxelGridState)
    })


def state_to_numpy(state) -> dict:
    """Host arrays keyed by field name, of this package's state or of any
    object with the same fields (a JAX package state converts likewise)."""
    out = {}
    for f in dataclasses.fields(VoxelGridState):
        value = getattr(state, f.name)
        out[f.name] = value.cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
    return out


def _field(arrays, name):
    return arrays[name] if isinstance(arrays, dict) else getattr(arrays, name)


# -----------------------------------------------------------------------------
# Index helpers (the XLA idioms)
# -----------------------------------------------------------------------------


def _scatter_drop(target: torch.Tensor, index: torch.Tensor, keep: torch.Tensor,
                  values) -> torch.Tensor:
    """``target.at[where(keep, index, N)].set(values, mode="drop")`` of a 1-D
    target: the dropped rows land on a spare slot that is cut off."""
    n = target.shape[0]
    ext = torch.cat([target, target.new_zeros(1)])
    values = torch.as_tensor(values, dtype=target.dtype, device=target.device)
    values = values.expand(index.shape)
    ext.scatter_(0, torch.where(keep, index.long(), n), values)
    return ext[:n]


def _nonzero_static(flags: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """``jnp.nonzero(flags, size=size, fill_value=fill_value)[0]``: the
    indices of the first ``size`` set entries of a 1-D mask, in order,
    padded with ``fill_value`` (int64)."""
    rank = torch.cumsum(flags.to(torch.int64), 0) - 1
    out = torch.full((size + 1,), fill_value, dtype=torch.int64, device=flags.device)
    keep = flags & (rank < size)
    out.scatter_(0, torch.where(keep, rank, size),
                 torch.arange(flags.shape[0], device=flags.device))
    return out[:size]


def _any_per_block(x: torch.Tensor, config: MappingConfig) -> torch.Tensor:
    """(X, Y, Z) bool -> (BX, BY, BZ): any voxel of the block set."""
    b = config.block_size
    BX, BY, BZ = config.block_grid_shape
    return x.reshape(BX, b, BY, b, BZ, b).any(dim=5).any(dim=3).any(dim=1)


# -----------------------------------------------------------------------------
# Geometry helpers
# -----------------------------------------------------------------------------


def voxel_centers_flat(config: MappingConfig, device: DeviceLike = None) -> torch.Tensor:
    """(V, 3) world coordinates of all voxel centres (V = X*Y*Z)."""
    X, Y, Z = config.grid_shape
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in (X, Y, Z)]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    origin = torch.tensor(config.aabb_min_m, dtype=torch.float32, device=device)
    return origin + (idx + 0.5) * config.voxel_size_m


def _project(points_w: torch.Tensor, T_WC: torch.Tensor, K: torch.Tensor):
    """World points (N, 3) -> (u, v, z): pixel coords + camera-frame depth.

    ``T_WC`` is camera-to-world; ``K`` the 3x3 intrinsics. The rotation
    R^T (p - t) is written out per component, a 3-term sum in one fixed
    order on every device (a matmul's order depends on the library). XLA's
    CPU dot fuses some of these products into FMAs, so z can differ from
    the JAX package's by an ulp.
    """
    R = T_WC[:3, :3]
    d = points_w - T_WC[:3, 3]
    p_c = d[:, 0:1] * R[0] + d[:, 1:2] * R[1] + d[:, 2:3] * R[2]
    z = p_c[:, 2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = K[0, 0] * p_c[:, 0] / safe_z + K[0, 2]
    v = K[1, 1] * p_c[:, 1] / safe_z + K[1, 2]
    return u, v, z


def _nearest_gather(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Nearest-neighbour gather of img (H, W[, C]) at float pixel coords.

    ``torch.round`` rounds half to even, as ``jnp.round`` does; clamping
    before the cast keeps every coordinate defined, and equals clamping
    after it wherever the pixel is inside the image.
    """
    H, W = img.shape[:2]
    ui = torch.round(u).clamp(0, W - 1).long()
    vi = torch.round(v).clamp(0, H - 1).long()
    return img[vi, ui], ui, vi


def _in_image(u, v, shape):
    H, W = shape[:2]
    return (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)


# -----------------------------------------------------------------------------
# TSDF integration
# -----------------------------------------------------------------------------


def _integrate_depth(tsdf, weight, depth, T_WC, K, mask, config: MappingConfig):
    trunc = config.truncation_distance_m
    centers = voxel_centers_flat(config, tsdf.device)
    u, v, z = _project(centers, T_WC, K)
    in_image = _in_image(u, v, depth.shape)
    surf, ui, vi = _nearest_gather(depth, u, v)
    surf = torch.nan_to_num(surf, nan=0.0, posinf=0.0, neginf=0.0)
    pixel_ok = surf > 0
    if mask is not None:
        pixel_ok &= mask[vi, ui]
    depth_ok = ((z > config.min_integration_distance_m)
                & (z < config.projective_integrator_max_integration_distance_m))
    sdf = surf - z
    update = in_image & pixel_ok & depth_ok & (sdf > -trunc)
    sdf = sdf.clamp(-trunc, trunc)

    w_old = weight.reshape(-1)
    tsdf_old = tsdf.reshape(-1)
    w_meas = update.to(torch.float32)
    w_new = w_old + w_meas
    safe_w = torch.where(w_new > 0, w_new, torch.ones_like(w_new))
    tsdf_new = (tsdf_old * w_old + sdf * w_meas) / safe_w
    tsdf_new = torch.where(update, tsdf_new, tsdf_old)
    w_new = w_new.clamp(max=config.max_tsdf_weight)
    return tsdf_new.reshape(tsdf.shape), w_new.reshape(weight.shape)


def integrate_depth(
    state: VoxelGridState,
    config: MappingConfig,
    depth: torch.Tensor,
    T_WC: torch.Tensor,
    K: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> VoxelGridState:
    """Fuse one masked depth frame into the TSDF (projective update).

    Args:
        depth: (H, W) metric depth (0 / non-finite = invalid).
        T_WC: (4, 4) camera-to-world transform.
        K: (3, 3) intrinsics for the depth image resolution.
        mask: optional (H, W) bool; False pixels are not integrated.
    """
    tsdf, weight = _integrate_depth(state.tsdf, state.weight, depth, T_WC, K, mask, config)
    return dataclasses.replace(state, tsdf=tsdf, weight=weight)


def _decay(tsdf, weight, config: MappingConfig):
    w = weight * config.tsdf_decay_factor
    dead = w < 1e-2
    return (torch.where(dead, torch.full_like(tsdf, config.truncation_distance_m), tsdf),
            torch.where(dead, torch.zeros_like(w), w))


def _decay_pool_weight(pool_weight, config: MappingConfig):
    w = pool_weight * config.tsdf_decay_factor
    return torch.where(w < 1e-2, torch.zeros_like(w), w)


def decay(state: VoxelGridState, config: MappingConfig) -> VoxelGridState:
    """Multiplicative weight decay; fully decayed voxels become unobserved.

    Feature and color averaging weights decay by the same factor, so a
    surface that returns re-averages against a faded mean. Pages are
    reclaimed by ``allocate_pages`` once their block has no observed voxel.
    """
    tsdf, weight = _decay(state.tsdf, state.weight, config)
    return dataclasses.replace(
        state, tsdf=tsdf, weight=weight,
        feat_weight=_decay_pool_weight(state.feat_weight, config),
        color_weight=_decay_pool_weight(state.color_weight, config),
    )


# -----------------------------------------------------------------------------
# Block page allocation + feature / color integration
# -----------------------------------------------------------------------------


def _allocate_pages(tsdf, weight, page_table, page_to_block, feat_weight, color_weight,
                    config: MappingConfig):
    """Reclaim dead pages, then assign free pages to near-surface blocks."""
    P = config.max_feature_pages
    observed = weight > 0
    block_observed = _any_per_block(observed, config).reshape(-1)

    # --- reclaim: pages whose block holds no observed voxel -------------------
    page_valid = page_to_block >= 0
    safe_block = page_to_block.clamp(min=0).long()
    freeable = page_valid & ~block_observed[safe_block]
    flat_table = _scatter_drop(page_table.reshape(-1), safe_block, freeable, -1)
    page_to_block = torch.where(freeable, torch.full_like(page_to_block, -1), page_to_block)
    feat_weight = torch.where(freeable[:, None], torch.zeros_like(feat_weight), feat_weight)
    color_weight = torch.where(freeable[:, None], torch.zeros_like(color_weight), color_weight)

    # --- allocate: a cumsum over the blocks that need a page ------------------
    near = (tsdf.abs() < config.truncation_distance_m * 0.75) & observed
    active = _any_per_block(near, config).reshape(-1)
    needs = active & (flat_table < 0)
    order = torch.cumsum(needs.to(torch.int64), 0) - 1  # alloc rank per block

    free = page_to_block < 0
    num_free = free.sum()
    free_ids = _nonzero_static(free, P, P)
    new_page = free_ids[order.clamp(0, P - 1)]
    can_alloc = needs & (order < num_free)
    flat_table = torch.where(can_alloc, new_page.to(torch.int32), flat_table)

    block_ids = torch.arange(flat_table.shape[0], dtype=torch.int32, device=flat_table.device)
    page_to_block = _scatter_drop(page_to_block, new_page, can_alloc, block_ids)
    num_pages = (page_to_block >= 0).sum().to(torch.int32)
    return (flat_table.reshape(page_table.shape), page_to_block, num_pages,
            feat_weight, color_weight)


def allocate_pages(state: VoxelGridState, config: MappingConfig) -> VoxelGridState:
    """Reclaim + assign pool pages for near-surface blocks.

    Deterministic cumsum allocation over the free list; silently stops
    allocating when the pool is exhausted. ``num_pages`` tracks the live
    allocated-page count.
    """
    page_table, page_to_block, num_pages, feat_weight, color_weight = _allocate_pages(
        state.tsdf, state.weight, state.page_table, state.page_to_block,
        state.feat_weight, state.color_weight, config)
    return dataclasses.replace(
        state, page_table=page_table, page_to_block=page_to_block, num_pages=num_pages,
        feat_weight=feat_weight, color_weight=color_weight)


def _page_voxel_coords(page_to_block: torch.Tensor, config: MappingConfig):
    """Per-page voxel integer coords (P, B^3, 3) + page-valid mask (P,)."""
    b = config.block_size
    BX, BY, BZ = config.block_grid_shape
    valid = page_to_block >= 0
    safe = page_to_block.clamp(min=0).long()
    base = torch.stack([safe // (BY * BZ), (safe // BZ) % BY, safe % BZ], dim=-1) * b
    r = torch.arange(b, device=page_to_block.device)
    offsets = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    return base[:, None, :] + offsets[None, :, :], valid


def _integrate_pool(pool, pool_weight, page_to_block, tsdf, weight, image, T_WC, K, mask,
                    config: MappingConfig, measurement_weight: float):
    """Weighted-average update of a per-voxel page pool from one image.

    The average runs in fp32 over the whole pool and is cast back to the
    pool's dtype; voxels without weight keep their value bit for bit.
    """
    coords, page_valid = _page_voxel_coords(page_to_block, config)  # (P, B^3, 3)
    P, B3, _ = coords.shape
    X, Y, Z = config.grid_shape
    origin = torch.tensor(config.aabb_min_m, dtype=torch.float32, device=pool.device)
    centers = origin + (coords.to(torch.float32) + 0.5) * config.voxel_size_m

    u, v, z = _project(centers.reshape(-1, 3), T_WC, K)
    in_image = _in_image(u, v, image.shape)
    values, ui, vi = _nearest_gather(image, u, v)
    ok = in_image & (z > config.min_integration_distance_m) & (
        z < config.projective_integrator_max_integration_distance_m)
    if mask is not None:
        ok &= mask[vi, ui]

    # Only near-surface observed voxels accumulate appearance.
    flat_vox = ((coords[..., 0] * Y + coords[..., 1]) * Z + coords[..., 2]).reshape(-1)
    tsdf_flat = tsdf.reshape(-1)[flat_vox]
    w_flat = weight.reshape(-1)[flat_vox]
    near = (tsdf_flat.abs() < config.truncation_distance_m * 0.75) & (w_flat > 0)
    ok = ok & near & page_valid.repeat_interleave(B3)

    w_meas = torch.where(ok, measurement_weight, 0.0).reshape(P, B3)
    w_new = pool_weight + w_meas
    safe_w = torch.where(w_new > 0, w_new, torch.ones_like(w_new))
    acc = pool.to(torch.float32) * pool_weight[..., None]
    acc += values.reshape(P, B3, -1).to(torch.float32) * w_meas[..., None]
    acc /= safe_w[..., None]
    # fp16 -> fp32 -> fp16 is exact, so keeping the old entry equals the
    # JAX package's where-then-cast.
    pool_new = torch.where((w_new > 0)[..., None], acc.to(pool.dtype), pool)
    return pool_new, w_new


def integrate_features(
    state: VoxelGridState,
    config: MappingConfig,
    features: torch.Tensor,
    T_WC: torch.Tensor,
    K: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> VoxelGridState:
    """Fuse a (H, W, F) feature image into the block-paged feature pool."""
    state = allocate_pages(state, config)
    feat, feat_weight = _integrate_pool(
        state.feat, state.feat_weight, state.page_to_block, state.tsdf, state.weight,
        features, T_WC, K, mask, config,
        config.projective_appearance_integrator_measurement_weight)
    return dataclasses.replace(state, feat=feat, feat_weight=feat_weight)


def integrate_color(
    state: VoxelGridState,
    config: MappingConfig,
    rgb: torch.Tensor,
    T_WC: torch.Tensor,
    K: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> VoxelGridState:
    """Fuse a (H, W, 3) color image into the color pool."""
    state = allocate_pages(state, config)
    color, color_weight = _integrate_pool(
        state.color, state.color_weight, state.page_to_block, state.tsdf, state.weight,
        rgb, T_WC, K, mask, config, 1.0)
    return dataclasses.replace(state, color=color, color_weight=color_weight)


# -----------------------------------------------------------------------------
# Surface extraction
# -----------------------------------------------------------------------------


def extract_surface_vertices(
    state: VoxelGridState, config: MappingConfig, max_vertices: int,
    return_count: bool = False,
):
    """Extract surface points with per-vertex features.

    Surface voxels are observed voxels whose TSDF crosses zero against a
    +x/+y/+z neighbour; the vertex sits at the zero crossing along that axis
    (linear interpolation), and its features blend the two endpoints' pool
    slots by the crossing position.

    Returns (vertices (N, 3), features (N, F), valid (N,)) with N =
    max_vertices, invalid rows zero; with ``return_count`` also the total
    crossing count (above max_vertices when the budget truncated the
    surface, by voxel linear index).
    """
    tsdf, weight = state.tsdf, state.weight
    X, Y, Z = config.grid_shape
    device = tsdf.device
    observed = weight > 0
    centers = voxel_centers_flat(config, device).reshape(X, Y, Z, 3)
    all_pos, all_flags = [], []
    for axis in range(3):
        shifted_t = torch.roll(tsdf, -1, dims=axis)
        shifted_o = torch.roll(observed, -1, dims=axis)
        # Exclude the wrap-around at the boundary.
        edge_valid = torch.ones_like(observed)
        edge_valid.narrow(axis, edge_valid.shape[axis] - 1, 1).fill_(False)
        crossing = (observed & shifted_o & edge_valid
                    & (torch.sign(tsdf) != torch.sign(shifted_t))
                    & (tsdf.abs() < config.truncation_distance_m))
        denom = tsdf - shifted_t
        alpha = torch.where(denom.abs() > 1e-9, tsdf / denom, torch.full_like(tsdf, 0.5))
        pos = centers.clone()
        pos[..., axis] = centers[..., axis] + alpha * config.voxel_size_m
        all_pos.append(pos.reshape(-1, 3))
        all_flags.append(crossing.reshape(-1))
    positions = torch.cat(all_pos, dim=0)
    flags = torch.cat(all_flags, dim=0)

    # The count is taken before truncation, so callers can detect overflow.
    count = flags.sum()
    sel = _nonzero_static(flags, max_vertices, 0)
    valid = torch.arange(max_vertices, device=device) < count
    vertices = torch.where(valid[:, None], positions[sel], 0.0)

    # Feature lookup: voxel -> block -> page -> slot, for both edge
    # endpoints, blended by the zero-crossing position.
    b = config.block_size
    page_table, feat, feat_weight = state.page_table, state.feat, state.feat_weight

    def lookup(vx, vy, vz):
        page = page_table[vx // b, vy // b, vz // b]
        slot = ((vx % b) * b + (vy % b)) * b + (vz % b)
        safe_page = page.clamp(min=0).long()
        f = feat[safe_page, slot].to(torch.float32)
        ok = (page >= 0) & (feat_weight[safe_page, slot] > 0)
        return f, ok

    axis_id = sel // (X * Y * Z)
    vox_flat = sel % (X * Y * Z)
    vx = vox_flat // (Y * Z)
    vy = (vox_flat // Z) % Y
    vz = vox_flat % Z
    nx = (vx + (axis_id == 0).long()).clamp(max=X - 1)
    ny = (vy + (axis_id == 1).long()).clamp(max=Y - 1)
    nz = (vz + (axis_id == 2).long()).clamp(max=Z - 1)
    f0, ok0 = lookup(vx, vy, vz)
    f1, ok1 = lookup(nx, ny, nz)
    t0 = tsdf[vx, vy, vz]
    t1 = tsdf[nx, ny, nz]
    denom = t0 - t1
    alpha = torch.where(denom.abs() > 1e-9, t0 / denom, torch.full_like(t0, 0.5)).clamp(0.0, 1.0)
    w0 = torch.where(ok0, 1.0 - alpha, 0.0)
    w1 = torch.where(ok1, alpha, 0.0)
    wsum = w0 + w1
    blended = (w0[:, None] * f0 + w1[:, None] * f1) / wsum.clamp(min=1e-9)[:, None]
    features = torch.where(((wsum > 0) & valid)[:, None], blended, 0.0)
    if return_count:
        return vertices, features, valid, count
    return vertices, features, valid


# -----------------------------------------------------------------------------
# The per-frame update
# -----------------------------------------------------------------------------


def fuse_frame(
    state: VoxelGridState,
    config: MappingConfig,
    depth: torch.Tensor,
    features: torch.Tensor,
    T_WC: torch.Tensor,
    K: torch.Tensor,
    feat_K: torch.Tensor,
    depth_mask: Optional[torch.Tensor] = None,
    with_decay: bool = True,
    feature_mask: Optional[torch.Tensor] = None,
) -> VoxelGridState:
    """One map update: decay + TSDF + page allocation + feature fusion.

    The color weights decay (and are freed with their pages) but no color
    is integrated, as in the JAX package's fused program. Masks are
    per-resolution: ``depth_mask`` at the depth image's, ``feature_mask`` at
    the feature image's.
    """
    if depth_mask is not None and tuple(depth_mask.shape) != tuple(depth.shape):
        raise ValueError(
            f"depth_mask shape {tuple(depth_mask.shape)} != depth {tuple(depth.shape)}; "
            "pass feature-resolution masks via feature_mask=")
    if feature_mask is not None and tuple(feature_mask.shape) != tuple(features.shape[:2]):
        raise ValueError(
            f"feature_mask shape {tuple(feature_mask.shape)} != feature image "
            f"{tuple(features.shape[:2])}")
    tsdf, weight = state.tsdf, state.weight
    in_fw, in_cw = state.feat_weight, state.color_weight
    if with_decay:
        tsdf, weight = _decay(tsdf, weight, config)
        in_fw = _decay_pool_weight(in_fw, config)
        in_cw = _decay_pool_weight(in_cw, config)
    tsdf, weight = _integrate_depth(tsdf, weight, depth, T_WC, K, depth_mask, config)
    page_table, page_to_block, num_pages, fw, cw = _allocate_pages(
        tsdf, weight, state.page_table, state.page_to_block, in_fw, in_cw, config)
    feat, feat_weight = _integrate_pool(
        state.feat, fw, page_to_block, tsdf, weight, features, T_WC, feat_K, feature_mask,
        config, config.projective_appearance_integrator_measurement_weight)
    return dataclasses.replace(
        state, tsdf=tsdf, weight=weight, page_table=page_table,
        page_to_block=page_to_block, num_pages=num_pages, feat=feat,
        feat_weight=feat_weight, color_weight=cw)
