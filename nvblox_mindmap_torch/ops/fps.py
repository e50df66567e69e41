"""Farthest point sampling (greedy max-min): the Hopper kernel and its plain
version.

Port of ``nvblox_mindmap_tpu/ops/fps.py``: FPS in *feature space*, starting
from ``start_idx``. ``torch.argmax`` returns the first index of the maximum,
as ``jnp.argmax`` does; ties occur, because the encoder zeroes invalid
tokens, and the first-index rule keeps the selected indices identical to the
JAX package's. The K - 1 selections are serial; each is a distance, min and
argmax over (B, N).

``farthest_point_sampling`` picks by device: a CPU tensor runs
``farthest_point_sampling_reference``, the eager loop; a CUDA tensor
launches ``csrc/fps.cu`` once for all K - 1 picks of all B rows, or raises.
There is no fallback between the two. The kernel computes the eager loop's
distances on the card to the bit (its source says how), so its picks are the
eager loop's, near-ties included. It takes contiguous float32 points whose
sum over C ATen reduces with one warp or less a row (``sum_lanes``: every
shape but B * N < 16 with C >= 64, or C above 8160), where some cluster of
up to 16 blocks holds a slice's running distances beside the candidate
vectors in shared memory (``launch_params``: up to ~860,000 points a row
at C = 120, ~196,000 at C = 2000, ~34,000 at C = 8160).
``farthest_point_sampling.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

KERNEL = "fps"  # csrc/fps.cu
SMEM_BYTES = 232448  # a block's dynamic shared memory on the H100
MAX_THREADS = 512
MAX_WARPS = MAX_THREADS // 32
MAX_CLUSTER = 16  # blocks a row may take: 8 is portable, the H100 takes 16
SPREAD_CLUSTER = 8  # the most blocks a row is spread over that fits in fewer
MIN_POINTS = 128  # a block's share of a row, below which fewer blocks serve it
BEST_BYTES = 8  # a (distance, index) pair


def farthest_point_sampling_reference(
    points: torch.Tensor, num_samples: int, start_idx: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eager loop: (B, K) int64 picks and the (B, N) running distances
    after the last fold (+inf throughout for K = 1)."""
    B, N, C = points.shape
    idx = torch.empty((B, num_samples), dtype=torch.int64, device=points.device)
    idx[:, 0] = start_idx
    min_dist = torch.full((B, N), float("inf"), dtype=points.dtype,
                          device=points.device)
    last = idx[:, :1]
    for i in range(1, num_samples):
        sel = torch.gather(points, 1, last[:, :, None].expand(B, 1, C))
        diff = points - sel
        min_dist = torch.minimum(min_dist, torch.sum(diff * diff, dim=-1))
        last = torch.argmax(min_dist, dim=-1, keepdim=True)
        idx[:, i:i + 1] = last
    return idx, min_dist


def _last_pow2(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def sum_lanes(rows: int, C: int) -> Tuple[int, bool]:
    """How ATen's CUDA ``sum`` over the last dim of a contiguous (rows, C)
    float32 tensor orders its additions (``ATen/native/cuda/Reduce.cuh``,
    ``setReduceConfig``): the lanes that share one row (its block width) and
    whether they read float4 vectors, from C = 128 on: in torch 2.11's
    ``setReduceConfig``, ``if (reduction_on_fastest_striding_dimension &&
    dim0 >= 128 && iter.num_reduce_dims() == 1)`` sets ``vectorize_input``.
    Raises where ATen would split a row over more than one warp: its order
    is then not the kernel's.
    """
    vec = C >= 128
    dim0 = C // 4 if vec else C
    dim0_pow2 = _last_pow2(dim0) if dim0 < MAX_THREADS else MAX_THREADS
    dim1_pow2 = _last_pow2(rows) if rows < MAX_THREADS else MAX_THREADS
    width = min(dim0_pow2, 32)
    height = min(dim1_pow2, MAX_THREADS // width)
    width = min(dim0_pow2, MAX_THREADS // height)
    values_per_lane = -(-C // width)
    if width > 32 or values_per_lane >= min(height * 16, 256):
        raise ValueError(
            f"the FPS kernel sums C in the order ATen uses for one warp per row; "
            f"ATen sums {rows} rows of C = {C} over more (B * N >= 16 with C >= 64 "
            f"and C <= 8160 stay within one warp)")
    return width, vec


def sel_floats(lanes: int, vec: bool, C: int) -> int:
    """Floats of the pick's vector in shared memory (``csrc/fps.cu``)."""
    return -(-C // 4) * 4 if vec else 4 * lanes


@dataclass(frozen=True)
class LaunchParams:
    lanes: int  # ATen's lanes per row (``sum_lanes``)
    vec: bool  # ... reading float4 vectors
    cluster: int  # blocks per row
    threads: int  # threads per block
    per_block: int  # points of a row per block
    resident: int  # of those, kept in shared memory (the rest read from L2)
    stride: int  # shared-memory row stride of one coordinate
    smem_bytes: int


def launch_params(B: int, N: int, C: int, K: int) -> LaunchParams:
    """The kernel's launch for (B, N, C) points and K picks.

    A row's points go to one block per ``MIN_POINTS`` points, up to
    ``SPREAD_CLUSTER`` blocks, or to the fewest blocks (up to
    ``MAX_CLUSTER``) whose shared memory holds them with their running
    distances where that is more: the fewer points a block holds, the shorter
    a pick, down to where the cluster's barrier costs more than the points,
    and fewer blocks a row leave room for more rows at once (a 3072 x 120 row
    was fastest over 8 blocks at B = 32, a 512 x 72 row over 4 at B = 1, a
    4096 x 120 row that streams nothing over 9 rather than 8; PERF.md). A
    slice larger than a block's shared memory keeps its first points there
    and reads the rest from global memory at every pick, over the most
    blocks (up to ``MAX_CLUSTER``) whose candidate vectors leave room for
    the slice's running distances.
    """
    if K > 1:
        lanes, vec = sum_lanes(B * N, C)
    else:  # no pick sums anything
        lanes, vec = 1, False
    cluster = 1
    while cluster < MAX_CLUSTER and not _fits(N, C, lanes, vec, cluster):
        cluster += 1
    cluster = max(cluster, min(SPREAD_CLUSTER, -(-N // MIN_POINTS)))
    while cluster > 1 and _room(N, C, lanes, vec, cluster) < 0:
        cluster -= 1
    return layout(N, C, lanes, vec, cluster)


def _fixed_bytes(C: int, lanes: int, vec: bool, cluster: int) -> int:
    """Shared memory beside the points: each block's candidate vector, two
    pick's worth, and the warps' and the blocks' bests."""
    return (4 * 2 * cluster * sel_floats(lanes, vec, C)
            + BEST_BYTES * (MAX_WARPS + 2 * cluster))


def _fits(N: int, C: int, lanes: int, vec: bool, cluster: int) -> bool:
    per_block = -(-N // cluster)  # coordinates with a column of padding, distances
    return (4 * C * (per_block + 1) + 4 * per_block
            + _fixed_bytes(C, lanes, vec, cluster) <= SMEM_BYTES)


def _room(N: int, C: int, lanes: int, vec: bool, cluster: int) -> int:
    """Bytes of a block's shared memory left for resident points when a row
    of N points goes over ``cluster`` blocks, beside the candidate vectors,
    the slice's running distances and one coordinate column of padding
    (negative: those do not fit)."""
    per_block = -(-N // cluster)
    cluster = -(-N // per_block)
    return SMEM_BYTES - _fixed_bytes(C, lanes, vec, cluster) - 4 * per_block - 4 * C


def layout(N: int, C: int, lanes: int, vec: bool, cluster: int) -> LaunchParams:
    """A row of N points over ``cluster`` blocks: as many points of each slice
    in shared memory as fit."""
    per_block = -(-N // cluster)
    cluster = -(-N // per_block)
    room = _room(N, C, lanes, vec, cluster)
    if room < 0:
        raise ValueError(f"the FPS kernel cannot hold the running distances of "
                         f"{per_block} points and C = {C} in shared memory")
    resident = min(per_block, room // (4 * C))
    stride = resident | 1
    threads = min(MAX_THREADS, 32 * -(-per_block // 32))
    smem_bytes = 4 * C * stride + 4 * per_block + _fixed_bytes(C, lanes, vec, cluster)
    return LaunchParams(lanes, vec, cluster, threads, per_block, resident, stride,
                        smem_bytes)


_LIB: Optional[Callable[..., int]] = None


def _library() -> Callable[..., int]:
    """The kernel's C entry point, built and loaded at first use."""
    global _LIB
    if _LIB is None:
        from nvblox_mindmap_torch.ops import _build

        fn = _build.load(KERNEL).farthest_point_sampling_fwd
        # points, out, dist; B, N, C, K, start, lanes, vec, cluster, threads,
        # per_block, resident, stride, smem; the stream.
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def run_kernel(
    points: torch.Tensor, num_samples: int, start_idx: int = 0,
    with_distances: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel on CUDA points: (B, K) int64 picks and the (B, N)
    running distances, as ``farthest_point_sampling_reference`` returns them
    (None without ``with_distances``: the kernel then stores none).

    Takes contiguous float32 (B, N, C) points, 1 <= K <= N and a start index
    in [0, N), with the shapes ``sum_lanes`` and ``launch_params`` take, and
    raises on anything else. Each launch adds one to
    ``farthest_point_sampling.launches``.
    """
    if points.dim() != 3:
        raise ValueError(f"the FPS kernel takes (B, N, C) points, got {tuple(points.shape)}")
    if points.device.type != "cuda":
        raise ValueError(f"the FPS kernel runs on cuda, not {points.device}")
    if points.dtype != torch.float32:
        raise TypeError(f"the FPS kernel takes float32 points, got {points.dtype}")
    if not points.is_contiguous():
        raise ValueError("the FPS kernel takes contiguous points")
    B, N, C = points.shape
    if not 1 <= num_samples <= N:
        raise ValueError(f"num_samples must be in [1, {N}], got {num_samples}")
    if not 0 <= start_idx < N:
        raise ValueError(f"start_idx must be in [0, {N}), got {start_idx}")
    if C < 1:
        raise ValueError("the FPS kernel takes points with C >= 1 coordinates")
    idx = torch.empty((B, num_samples), dtype=torch.int64, device=points.device)
    dist = (torch.empty((B, N), dtype=torch.float32, device=points.device)
            if with_distances else None)
    if B == 0:
        return idx, dist
    lp = launch_params(B, N, C, num_samples)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = _library()(
            points.data_ptr(), idx.data_ptr(), None if dist is None else dist.data_ptr(),
            B, N, C, num_samples,
            start_idx, lp.lanes, int(lp.vec), lp.cluster, lp.threads, lp.per_block,
            lp.resident, lp.stride, lp.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: CUDA error {err}")
    farthest_point_sampling.launches += 1
    return idx, dist


def farthest_point_sampling(
    points: torch.Tensor, num_samples: int, start_idx: int = 0
) -> torch.Tensor:
    """Greedy farthest point sampling.

    CPU points run ``farthest_point_sampling_reference``; CUDA points launch
    the kernel (see ``run_kernel`` for what it takes).

    Args:
        points: (B, N, C) point set (any feature space).
        num_samples: number of points K to select.
        start_idx: index of the first selected point.

    Returns:
        (B, K) int64 indices of the selected points.
    """
    _, N, _ = points.shape
    # Indices carry no gradient (``gather_points`` carries it to the picked
    # features): without detaching, autograd would keep every pick's
    # (B, N, C) difference for a backward pass that never reads it.
    points = points.detach()
    if not 1 <= num_samples <= N:
        raise ValueError(f"num_samples must be in [1, {N}], got {num_samples}")
    if points.device.type == "cpu":
        return farthest_point_sampling_reference(points, num_samples, start_idx)[0]
    return run_kernel(points, num_samples, start_idx, with_distances=False)[0]


farthest_point_sampling.launches = 0


def gather_points(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather along the point axis: values (B, N, ...), indices (B, K) -> (B, K, ...)."""
    idx = indices.reshape(indices.shape + (1,) * (values.dim() - 2))
    idx = idx.expand(indices.shape + values.shape[2:])
    return torch.gather(values, 1, idx)
