"""The block-paged pool update on the card: the launch of
``csrc/integrate_pool.cu``.

The mapper keeps per-voxel features and colors in a pool of pages, one page
per allocated 8^3 block (``mapping/voxel_grid.py``). Each camera frame
averages an image into it: ``voxel_grid._integrate_pool`` runs the plain
version (``_integrate_pool_reference``) on CPU tensors and ``integrate_pool``
here on CUDA tensors, with no fallback between the two. The kernel repeats
the plain version's roundings in their order, so the pool and its weights
come out equal to the bit (its source says how). It takes only the live
pages' voxels and rewrites only the rows whose new weight is positive.

The kernel updates the pool and the weights it is given in place: the
caller's tensors are donated. It takes an fp16 pool, fp32 weights, an fp16,
bf16 or fp32 (H, W, C) image, all contiguous (``launch_params``), and raises
on anything else. ``integrate_pool.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

KERNEL = "integrate_pool"  # csrc/integrate_pool.cu
IMAGE_KINDS = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
MAX_SLOTS = 512  # voxels of a page the kernel lists in shared memory
VEC = 8  # channels a lane moves per 16-byte load of the fp16 pool
MIN_VEC_CHANNELS = 64  # from here a row takes a group of lanes
MAX_LANES = 32


@dataclass(frozen=True)
class LaunchParams:
    lanes: int  # lanes a row; 1: a thread a row, a channel at a time
    image_kind: int  # IMAGE_KINDS of the image's dtype


def _check(cond: bool, message: str, error=ValueError):
    if not cond:
        raise error(message)


def launch_params(pool: torch.Tensor, pool_weight: torch.Tensor, page_to_block: torch.Tensor,
                  tsdf: torch.Tensor, weight: torch.Tensor, image: torch.Tensor,
                  T_WC: torch.Tensor, K: torch.Tensor, mask: Optional[torch.Tensor],
                  block_size: int) -> LaunchParams:
    """The kernel's launch for these arguments, or the reason it takes none.

    Checks dtypes, shapes and contiguity (not the device), then picks the
    layout from C: rows of at least ``MIN_VEC_CHANNELS`` channels, a multiple
    of ``VEC``, with pool and image 16-byte aligned, take a group of 8, 16 or
    32 lanes (the power of two that covers C / 8 chunks, at most 32); other
    rows a thread each.
    """
    _check(pool.dtype == torch.float16, f"the pool kernel takes an fp16 pool, got {pool.dtype}",
           TypeError)
    _check(pool_weight.dtype == torch.float32,
           f"the pool kernel takes fp32 pool weights, got {pool_weight.dtype}", TypeError)
    _check(page_to_block.dtype == torch.int32,
           f"the pool kernel takes an int32 page table, got {page_to_block.dtype}", TypeError)
    _check(tsdf.dtype == weight.dtype == torch.float32,
           f"the pool kernel takes an fp32 TSDF and weight, got {tsdf.dtype} / {weight.dtype}",
           TypeError)
    _check(image.dtype in IMAGE_KINDS,
           f"the pool kernel takes an fp16, bf16 or fp32 image, got {image.dtype}", TypeError)
    _check(T_WC.dtype == K.dtype == torch.float32,
           f"the pool kernel takes fp32 T_WC and K, got {T_WC.dtype} / {K.dtype}", TypeError)
    _check(mask is None or mask.dtype == torch.bool,
           f"the pool kernel takes a bool mask, got {None if mask is None else mask.dtype}",
           TypeError)

    slots = block_size**3
    _check(slots <= MAX_SLOTS,
           f"the pool kernel takes pages of at most {MAX_SLOTS} voxels, got block_size "
           f"{block_size}")
    _check(pool.dim() == 3 and pool.shape[1] == slots,
           f"the pool must be (P, {slots}, C), got {tuple(pool.shape)}")
    P, _, C = pool.shape
    _check(C >= 1, "the pool kernel takes C >= 1 channels")
    _check(tuple(pool_weight.shape) == (P, slots),
           f"pool weights {tuple(pool_weight.shape)} do not match the pool {(P, slots)}")
    _check(tuple(page_to_block.shape) == (P,),
           f"page_to_block {tuple(page_to_block.shape)} does not match the pool's {P} pages")
    _check(tsdf.dim() == 3 and tsdf.shape == weight.shape
           and all(n >= block_size and n % block_size == 0 for n in tsdf.shape),
           f"the TSDF {tuple(tsdf.shape)} and weight {tuple(weight.shape)} must be one grid of "
           f"whole {block_size}^3 blocks")
    _check(image.dim() == 3 and image.shape[2] == C and image.shape[0] >= 1
           and image.shape[1] >= 1,
           f"the image must be (H, W, {C}), got {tuple(image.shape)}")
    H, W = image.shape[:2]
    _check(H * W < 2**31, f"the pool kernel takes images of fewer than 2^31 pixels, got {H}x{W}")
    _check(tuple(T_WC.shape) == (4, 4), f"T_WC must be (4, 4), got {tuple(T_WC.shape)}")
    _check(tuple(K.shape) == (3, 3), f"K must be (3, 3), got {tuple(K.shape)}")
    _check(mask is None or tuple(mask.shape) == (H, W),
           f"the mask must be the image's (H, W) = {(H, W)}, got "
           f"{None if mask is None else tuple(mask.shape)}")
    for name, t in (("pool", pool), ("pool_weight", pool_weight),
                    ("page_to_block", page_to_block), ("tsdf", tsdf), ("weight", weight),
                    ("image", image), ("T_WC", T_WC), ("K", K), ("mask", mask)):
        _check(t is None or t.is_contiguous(), f"the pool kernel takes a contiguous {name}")

    lanes = 1
    aligned = pool.data_ptr() % 16 == 0 and image.data_ptr() % 16 == 0
    if C >= MIN_VEC_CHANNELS and C % VEC == 0 and aligned:
        chunks = C // VEC
        lanes = min(MAX_LANES, 1 << (chunks - 1).bit_length())
    return LaunchParams(lanes, IMAGE_KINDS[image.dtype])


_LIB: Optional[Callable[..., int]] = None


def _library() -> Callable[..., int]:
    """The kernel's C entry point, built and loaded at first use."""
    global _LIB
    if _LIB is None:
        from nvblox_mindmap_torch.ops import _build

        fn = _build.load(KERNEL).integrate_pool_fwd
        # pool, pool_weight, page_to_block, tsdf, weight, image, T, K, mask;
        # P, slots, C, H, W, X, Y, Z, b, image_kind, lanes; origin x/y/z,
        # voxel, near_tsdf, min_z, max_z, w_meas; the stream.
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_float] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def integrate_pool(pool, pool_weight, page_to_block, tsdf, weight, image, T_WC, K, mask,
                   config, measurement_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on CUDA tensors: ``pool`` and ``pool_weight``
    updated in place and returned, as ``voxel_grid._integrate_pool_reference``
    returns its new pool and weights for the same arguments.

    ``config`` is the map's ``MappingConfig``; its constants and
    ``measurement_weight`` are rounded to fp32 once, as the plain version's
    ops round them. Raises on what ``launch_params`` refuses and on tensors
    that are not all on one CUDA device. Each launch adds one to
    ``integrate_pool.launches``.
    """
    tensors = [pool, pool_weight, page_to_block, tsdf, weight, image, T_WC, K]
    if mask is not None:
        tensors.append(mask)
    _check(pool.device.type == "cuda", f"the pool kernel runs on cuda, not {pool.device}")
    _check(all(t.device == pool.device for t in tensors),
           f"the pool kernel takes every tensor on {pool.device}, got "
           f"{sorted({str(t.device) for t in tensors})}")
    lp = launch_params(pool, pool_weight, page_to_block, tsdf, weight, image, T_WC, K, mask,
                       config.block_size)
    P, slots, C = pool.shape
    H, W = image.shape[:2]
    X, Y, Z = tsdf.shape
    constants = [float(c) for c in (
        *config.aabb_min_m, config.voxel_size_m, config.truncation_distance_m * 0.75,
        config.min_integration_distance_m,
        config.projective_integrator_max_integration_distance_m, measurement_weight)]
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = _library()(
            pool.data_ptr(), pool_weight.data_ptr(), page_to_block.data_ptr(), tsdf.data_ptr(),
            weight.data_ptr(), image.data_ptr(), T_WC.data_ptr(), K.data_ptr(),
            None if mask is None else mask.data_ptr(),
            P, slots, C, H, W, X, Y, Z, config.block_size, lp.image_kind, lp.lanes,
            *constants, stream,
        )
    if err != 0:
        raise RuntimeError(f"integrate_pool kernel launch failed: CUDA error {err}")
    integrate_pool.launches += 1
    return pool, pool_weight


integrate_pool.launches = 0
