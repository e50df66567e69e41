"""Data-parallel layout and the process group (torch).

Port of ``nvblox_mindmap_tpu/parallel/mesh.py``. The JAX package trains over
a 1-D ``Mesh(('data',))``: batches sharded on the leading axis, parameters
replicated, and the gradient psum inserted by jit. Here each process drives
one device (upstream's DDP layout, ``run_training.py:608-613``): a
``DataMesh`` names the process's device, its rank and the world size; each
rank keeps its own rows of the global batch (``shard_batch``); parameters
start identical on every rank (``replicate``, a broadcast from rank 0); the
trainer averages the gradients over the ranks after ``backward``.

``maybe_init_distributed`` joins the process group that
``python -m torch.distributed.run`` (torchrun) describes in the environment.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple

import torch
import torch.distributed as dist

from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.parallel.multihost import get_rank, get_world_size


class DataMesh(NamedTuple):
    """One process's place in the data-parallel layout."""

    device: torch.device
    rank: int = 0
    world_size: int = 1


def make_data_mesh(device: DeviceLike = None) -> DataMesh:
    """This process's device (``cuda`` unless one is named: the current
    card, with its index), rank and world size (0 and 1 without a process
    group)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return DataMesh(device, get_rank(), get_world_size())


def local_rows(x, mesh: DataMesh):
    """The rank's rows of ``x``'s leading axis: the ``rank``-th of
    ``world_size`` equal blocks (a view, no copy)."""
    if mesh.world_size == 1:
        return x
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"batch of {n} rows does not split into {mesh.world_size} ranks")
    b = n // mesh.world_size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def on_mesh_device(x, mesh: DataMesh) -> bool:
    return isinstance(x, torch.Tensor) and x.device == mesh.device


def shard_batch(batch: Dict[str, Any], mesh: DataMesh) -> Dict[str, Any]:
    """The rank's part of a global batch, on the mesh's device.

    A host array (numpy or a CPU tensor) gives the rank's rows, copied to
    the device (through pinned memory, without blocking, on CUDA). A tensor
    already on the device is the rank's part as it stands (a packed
    epoch's staged slice, ``data/packed.py``): it is not copied again. None
    values (absent modalities) pass through.
    """

    def put(x):
        if x is None or on_mesh_device(x, mesh):
            return x
        x = local_rows(torch.as_tensor(x), mesh)
        if mesh.device.type == "cuda":
            return x.contiguous().pin_memory().to(mesh.device, non_blocking=True)
        return x.to(mesh.device)

    return {k: put(v) for k, v in batch.items()}


def replicate(module: torch.nn.Module, mesh: DataMesh) -> torch.nn.Module:
    """Make ``module``'s parameters and buffers rank 0's on every rank (a
    broadcast from rank 0; nothing to do on one rank)."""
    if mesh.world_size > 1:
        with torch.no_grad():
            for tensor in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(tensor, src=0)
    return module


def maybe_init_distributed(device: DeviceLike = None) -> None:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), once.

    On the card each rank drives ``cuda:LOCAL_RANK``; tensors of the
    gradient all-reduce go through NCCL and host objects (metrics, the
    asynchronous checkpoint's plans) through gloo. With ``device="cpu"``
    every collective goes through gloo. Without torchrun's variables, and
    when the group exists already, it does nothing.
    """
    if dist.is_initialized() or not all(
            v in os.environ for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return
    if resolve_device(device).type == "cpu":
        backend = "gloo"
    else:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
