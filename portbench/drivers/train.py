"""Training traffic: ``Trainer.train_one_step`` on batches made on the card
from the seed (the packed-epoch path: batches already resident), cycled.

Traffic parameters (``traffic/<name>.json``): ``batch`` rows, ``batches``
distinct batches, each with its own noise and timesteps from the seed;
``checked_steps`` first steps held to the reference.

Set-up builds one trainer, loads the benchmark's weights into it and warms
it up; then puts the same trainer back at those weights with a fresh
optimizer state and drives it through the checked steps, recording each
step's loss, the first gradient as the optimizer holds it after one step
(Adam's first moment over 1 - beta1) and the parameters' change after the
checked steps; and hands it on to the window, which goes on from there.
``correct`` holds these to the plain reference's three steps from the same
weights, batches and noise, by the worst leaf, and the frozen backbone to
its weights bit for bit.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

from portbench import roofline, scene
from portbench.drivers import common

BETA1 = 0.9
# Leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under Adam; their change is not compared.
ROUNDING_LEAF = 1e-3


class State:
    pass


def make_batches(run):
    cfg, tr = run.config, run.traffic
    m = cfg["model"]
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    batches = scene.train_batches(
        tr["batches"], tr["batch"], cfg["cameras"], cfg["image_size"],
        cfg["image_size"] // m["feature_image_size"][0], cfg["num_vertices_to_sample"],
        m["vertex_feature_dim"], m["nhist"], common.workspace(cfg), gen, run.device)
    noise = [(torch.randn((tr["batch"], 1, 1, 9), generator=gen, device=run.device),
              torch.randint(0, m["diffusion_timesteps"], (tr["batch"],), generator=gen,
                            device=run.device)) for _ in batches]
    return batches, noise


def leaf_norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def setup(run):
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    cfg, tr, dev = run.config, run.traffic, run.device
    st = State()
    trainer = Trainer(DiffuserActorConfig(**common.model_fields(cfg)),
                      TrainerConfig(batch_size=tr["batch"], seed=run.seed,
                                    train_iters=tr["train_iters"], save_checkpoint=False),
                      common.workspace(cfg), device=dev)
    with torch.device(dev):
        model, optimizer = trainer.init_state()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    state = common.seeded_state(shapes, cfg, run.seed, dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])
    del state
    st.trainer, st.model, st.optimizer = trainer, model, optimizer
    st.batches, st.noise = make_batches(run)
    st.step = 0
    seeded = {n: t.detach().clone() for n, t in model.state_dict().items()}
    fresh = copy.deepcopy(optimizer.state_dict())
    if run.trace:
        run.flops["train_step"] = roofline.count_flops(lambda: train_step(st))
    run.warm_up(lambda: train_step(st))
    # The checked steps come last, on the path the window times: the same
    # trainer back at the seeded weights and a fresh optimizer state.
    model.load_state_dict(seeded)
    optimizer.load_state_dict(fresh)
    del seeded, fresh
    st.step = 0
    named = dict(zip(optimizer.names, optimizer.params))
    start = {n: p.detach().clone() for n, p in named.items()}
    st.losses = []
    for _ in range(tr["checked_steps"]):
        st.losses.append(float(train_step(st)["total"]))
        if st.step == 1:
            st.grads = leaf_norms({
                n: optimizer.adamw.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                for n, p in named.items()})
    st.changes = leaf_norms({n: p.detach() - start[n] for n, p in named.items()})
    del start
    if run.trace:
        install_ranges(run, st)
    return st


def train_step(st):
    i = st.step % len(st.batches)
    noise, timesteps = st.noise[i]
    losses = st.trainer.train_one_step(st.batches[i], st.step, noise, timesteps)
    st.step += 1
    return losses


def install_ranges(run, st) -> None:
    """Profiler ranges around FPS and the frozen extractor's forward (its
    hooks open and close them), for the device time under each."""
    from portbench import idle

    encoder = st.model.encoder
    run_fps = encoder.run_fps

    def fps(*args, **kwargs):
        with torch.profiler.record_function(idle.SPAN_PREFIX + "fps"):
            return run_fps(*args, **kwargs)

    encoder.run_fps = fps
    backbone = encoder.feature_extractor
    ranges = []
    st.hooks = [
        backbone.register_forward_pre_hook(lambda *_: ranges.append(
            torch.profiler.record_function(idle.SPAN_PREFIX + "backbone").__enter__())),
        backbone.register_forward_hook(lambda *_: ranges.pop().__exit__(None, None, None)),
    ]


def window(run, st) -> None:
    run.open_window()
    losses = []
    while run.more():
        with run.unit("train_step"):
            losses.append(train_step(st)["total"])
    run.close_window()
    run.attempted = len(losses)
    run.failed = sum(not math.isfinite(float(x)) for x in losses)
    run.counts["samples"] = run.traffic["batch"] * len(losses)
    run.notes.update(steps_before_window=st.step - len(losses), window_steps=len(losses),
                     flops_per_step=run.flops.get("train_step"), checked_losses=st.losses)


def release(run, st) -> None:
    """Reads the backbone against the benchmark's weights, then frees the
    program's state."""
    backbone = {n: p for n, p in st.model.named_parameters()
                if n.startswith("encoder.feature_extractor.")
                and n not in st.optimizer.names}
    shapes = {n: tuple(p.shape) for n, p in st.model.named_parameters()}
    state = common.seeded_state(shapes, run.config, run.seed, run.device)
    st.backbone_changed = float(sum(not torch.equal(p, state[n]) for n, p in backbone.items()))
    del state, backbone, shapes
    for hook in getattr(st, "hooks", []):
        hook.remove()
    del st.trainer, st.model, st.optimizer, st.batches, st.noise
    common.free(run.device)


def reference_readings(run, lowered: bool, half_batch: bool = False) -> dict:
    """The plain reference's checked steps from the same weights, batches
    and noise, in its own arithmetic or the control's (``lowered``):
    losses, first-gradient and change norms by leaf. With
    ``half_batch`` (a planted fault) each step's loss is the mean over the
    first half of the batch."""
    from portbench.reference.models.diffuser_actor import (
        DiffuserActor,
        DiffuserActorConfig,
        diffusion_train_loss,
        prepare_inputs,
    )
    from portbench.reference.precision import arithmetic
    from portbench.reference.training.optimizer import Optimizer, frozen_feature_extractor_mask

    cfg, tr, dev = run.config, run.traffic, run.device
    with arithmetic(lowered):
        model = common.build_model(DiffuserActor, DiffuserActorConfig, cfg, run.seed, dev)
        optimizer = Optimizer(model, total_iters=tr["train_iters"],
                              trainable_mask=frozen_feature_extractor_mask(model))
        named = dict(zip(optimizer.names, optimizer.params))
        start = {n: p.detach().clone() for n, p in named.items()}
        batches, noise = make_batches(run)
        bounds = common.workspace(cfg)
        losses, grads = [], None
        model.train()
        for step in range(tr["checked_steps"]):
            i = step % len(batches)
            batch, (eps, timesteps) = batches[i], noise[i]
            if half_batch:
                rows = tr["batch"] // 2
                batch = {k: v[:rows] for k, v in batch.items()}
                eps, timesteps = eps[:rows], timesteps[:rows]
            prepared = prepare_inputs(batch, bounds, model.config, device=dev)
            loss = diffusion_train_loss(model, prepared, eps, timesteps)
            loss["total"].backward()
            losses.append(float(loss["total"].detach()))
            if step == 0:
                grads = leaf_norms({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                    for n, p in named.items()})
            optimizer.step()
            optimizer.zero_grad()
        changes = leaf_norms({n: p.detach() - start[n] for n, p in named.items()})
    del model, optimizer, named, start, batches, noise
    common.free(dev)
    return {"losses": losses, "grads": grads, "changes": changes}


def gaps(program: dict, reference: dict) -> dict:
    """Worst-leaf gaps: |program norm - reference norm| over the larger of
    the reference leaf's norm and the median leaf's; the change leaves out
    leaves whose reference gradient is rounding (``ROUNDING_LEAF``)."""
    def worst(a: dict, b: dict, leaves) -> float:
        median = float(np.median([b[n] for n in leaves]))
        return max(abs(a[n] - b[n]) / max(b[n], median) for n in leaves)

    if set(program["grads"]) != set(reference["grads"]):
        return {"loss_gap": math.inf}
    grad_median = float(np.median(list(reference["grads"].values())))
    moved = [n for n, g in reference["grads"].items() if g >= ROUNDING_LEAF * grad_median]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))
    return {"loss_gap": float(loss_gap),
            "grad_gap": worst(program["grads"], reference["grads"], list(reference["grads"])),
            "change_gap": worst(program["changes"], reference["changes"], moved)}


def check(run, st) -> dict:
    program = {"losses": st.losses, "grads": st.grads, "changes": st.changes}
    out = gaps(program, reference_readings(run, lowered=False))
    out["backbone_changed"] = st.backbone_changed
    return out


def control(run, st) -> dict:
    """The control's readings: the reference in the control's arithmetic
    (``reference/precision.py``) put in the program's place, held to the
    reference by the same gaps."""
    return gaps(reference_readings(run, lowered=True), reference_readings(run, lowered=False))


def faults(run, st) -> dict:
    """Readings of the faults a training step can have, planted in the
    reference put in the program's place: half of the batch left out (a
    run); a step that leaves its state unchanged reads 1 in ``change_gap``
    by its measure and needs none."""
    return {"half_batch": gaps(reference_readings(run, lowered=False, half_batch=True),
                               reference_readings(run, lowered=False))}
