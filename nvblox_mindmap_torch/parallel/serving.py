"""Batched inference over one or several devices (serving).

Port of ``nvblox_mindmap_tpu/parallel/serving.py``. The JAX package serves
one large request batch as one jitted program over the data mesh: the
parameters replicated, the batch split on its leading axis, every chip
running the whole reverse-diffusion sampler on its share. Here each device
holds a replica of the model and samples its block of rows; on one card
that is one sampler call at the whole batch. The noise of the whole batch
is drawn once (or given) and split with the rows, so a call over n devices
equals a call over one, row for row. With several devices each runs on a
host thread of its own: the eager sampler's host loop would otherwise run
them one after another.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs, sample_trajectory


def make_sharded_infer_fn(
    model,
    bounds,
    devices: Optional[Sequence[DeviceLike]] = None,
    num_inference_steps: Optional[int] = None,
    scheduler_kind: str = "ddpm",
    stochastic: Optional[bool] = None,
) -> Callable:
    """Build a batch predictor over ``devices``.

    Args:
        model: a ``DiffuserActor`` (its configuration; the weights come with
            each call).
        bounds: (2, 3) workspace bounds.
        devices: the devices that share a batch (default: every CUDA card;
            without one this raises unless devices are named, e.g.
            ``["cpu"]``). The request batch's leading dimension must be
            divisible by their count.
        num_inference_steps / scheduler_kind / stochastic: sampler overrides
            (e.g. 10 / "ddim" for low-latency serving); the output of
            ``models/converter.py:convert_diffusion_scheduler`` is accepted
            as it is. ``stochastic`` defaults to False for DDIM and True for
            DDPM.

    Returns:
        ``infer(params, batch, generator=None, init_noise=None,
        step_noise=None) -> (trajectory, head_yaw, weights)`` on the first
        device. ``params`` is a ``state_dict`` of the model; it is copied to
        the devices once per distinct object (hold one object across calls).
        ``batch`` holds host arrays or tensors. The noise is ``init_noise``
        (B, L, G, 9) and, when stochastic, ``step_noise`` (T, B, L, G, 9),
        or drawn from ``generator`` as ``sample_trajectory`` draws it.
        ``infer.copies`` counts the parameter copies made.
    """
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    cfg = model.config
    if stochastic is None:
        stochastic = scheduler_kind == "ddpm"
    sampler = dict(num_inference_steps=num_inference_steps, scheduler_kind=scheduler_kind,
                   stochastic=stochastic)
    steps = len(cfg.schedules(kind=scheduler_kind)[0].timesteps(num_inference_steps))
    # Replicate the parameters once per distinct object: copying them on
    # every request would move the whole model per call, more than a DDIM-10
    # sample costs. Keyed by the object itself (held, so its id cannot be
    # reused by another).
    cache: Dict[str, Any] = {"params": None, "replicas": None}

    def replicas(params) -> List[torch.nn.Module]:
        if cache["params"] is not params:
            out = []
            for device in devices:
                replica = copy.deepcopy(model).to(device).eval()
                replica.load_state_dict(params)
                out.append(replica)
            cache["params"], cache["replicas"] = params, out
            infer.copies += 1
        return cache["replicas"]

    def infer(params, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
              init_noise: Optional[torch.Tensor] = None,
              step_noise: Optional[torch.Tensor] = None):
        n = len(devices)
        lead = next(v.shape[0] for v in batch.values() if v is not None)
        if lead % n != 0:
            raise ValueError(f"serving batch size {lead} not divisible by mesh size {n}")
        if init_noise is None:
            if generator is None:
                raise ValueError("pass init_noise (and step_noise), or a torch.Generator")
            shape = (lead, cfg.prediction_horizon, cfg.ngrippers, 9)
            init_noise = torch.randn(shape, generator=generator, device=generator.device)
            if stochastic:
                step_noise = torch.randn((steps,) + shape, generator=generator,
                                         device=generator.device)
        elif stochastic and step_noise is None:
            raise ValueError("stochastic sampling with init_noise needs step_noise")
        models = replicas(params)
        b = lead // n

        def shard(i):
            rows = slice(i * b, (i + 1) * b)
            device = devices[i]
            context = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
            with context:
                prepared = prepare_inputs({k: None if v is None else v[rows]
                                           for k, v in batch.items()}, bounds, cfg, device=device)
                return sample_trajectory(
                    models[i], prepared, bounds, init_noise=init_noise[rows],
                    step_noise=step_noise[:, rows] if stochastic else None, **sampler)

        if n == 1:
            return shard(0)
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            parts = list(pool.map(shard, range(n)))
        first = devices[0]
        return tuple(None if part[0] is None else torch.cat([p.to(first) for p in part])
                     for part in zip(*parts))

    infer.copies = 0
    return infer
