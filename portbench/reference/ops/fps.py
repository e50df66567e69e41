"""Farthest point sampling (greedy max-min) in torch.

Port of ``nvblox_mindmap_tpu/ops/fps.py``: FPS in *feature space*, starting
from index 0. ``torch.argmax`` returns the first index of the maximum, as
``jnp.argmax`` does; ties occur, because the encoder zeroes invalid tokens,
and the first-index rule keeps the selected indices identical to the JAX
package's. The K - 1 selections are serial; each is a small distance, min
and argmax over (B, N). This stays plain torch: whether it needs a kernel is
decided by its measured time on the card (PERF.md).
"""
from __future__ import annotations

import torch


def farthest_point_sampling(
    points: torch.Tensor, num_samples: int, start_idx: int = 0
) -> torch.Tensor:
    """Greedy farthest point sampling.

    Args:
        points: (B, N, C) point set (any feature space).
        num_samples: number of points K to select.
        start_idx: index of the first selected point.

    Returns:
        (B, K) int64 indices of the selected points.
    """
    B, N, C = points.shape
    # Indices carry no gradient (``gather_points`` carries it to the picked
    # features): without detaching, autograd would keep every pick's
    # (B, N, C) difference for a backward pass that never reads it.
    points = points.detach()
    if not 1 <= num_samples <= N:
        raise ValueError(f"num_samples must be in [1, {N}], got {num_samples}")
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
    return idx


def gather_points(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather along the point axis: values (B, N, ...), indices (B, K) -> (B, K, ...)."""
    idx = indices.reshape(indices.shape + (1,) * (values.dim() - 2))
    idx = idx.expand(indices.shape + values.shape[2:])
    return torch.gather(values, 1, idx)
