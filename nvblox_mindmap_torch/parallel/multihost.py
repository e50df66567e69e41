"""Multi-process collectives for metrics and synchronization (torch).

Port of ``nvblox_mindmap_tpu/parallel/multihost.py`` on ``torch.distributed``
(upstream's ``model_utils/distributed_training.py`` does the same with
pickled ``all_gather``): metric dicts are exchanged with
``all_gather_object``, barriers with ``barrier``. Without a process group of
more than one rank each helper gives the single-process answer: rank 0,
world size 1, ``[metrics]`` and a barrier that returns at once.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_distributed() -> bool:
    return _initialized() and dist.get_world_size() > 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def print_dist(*args, **kwargs):
    """Print only on rank 0 (upstream ``print_dist``)."""
    if get_rank() == 0:
        print(*args, **kwargs)


def _host(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
    return np.asarray(value)


def all_gather_metrics(metrics: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Gather a metric dict from every rank; returns the per-rank list in
    rank order. Single-process: ``[metrics]``."""
    if not is_distributed():
        return [dict(metrics)]
    gathered: List[Any] = [None] * get_world_size()
    dist.all_gather_object(gathered, {k: _host(v) for k, v in metrics.items()})
    return gathered


def mean_metrics_across_processes(metrics: Dict[str, Any]) -> Dict[str, Any]:
    gathered = all_gather_metrics(metrics)
    return {k: np.mean([g[k] for g in gathered], axis=0) for k in gathered[0]}


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (e.g. a run directory named after the
    clock). Single-process: ``obj``."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(name: str = "barrier"):
    """Wait for every rank (upstream: ``dist.barrier`` around rank-0 work).
    ``name`` labels the call site, as the JAX package's
    ``sync_global_devices`` does."""
    if is_distributed():
        dist.barrier()
