"""Optimizer and learning-rate schedule (torch).

Port of ``nvblox_mindmap_tpu/training/optimizer.py`` (optax), upstream's
training recipe:

- AdamW as optax defines it: b1 0.9, b2 0.999, eps 1e-8 added outside the
  square root of the bias-corrected second moment, and weight decay (5e-4)
  decoupled from the moments and scaled by the scheduled learning rate.
  ``torch.optim.AdamW`` computes the same update; each step sets its
  learning rate from the schedule.
- No decay for biases and LayerNorm parameters. The rule reads the flax
  names (``bias``; ``LayerNorm`` in the path; ``scale`` / ``offset``), which
  ``models.weights.flax_paths`` gives for the port's parameters: torch calls
  a LayerNorm's ``scale`` ``weight``, so a rule on torch names alone would
  decay every LayerNorm.
- ``linear_lr_schedule``: LinearLR from 1.0x to ``end_factor`` over
  ``convergence_percentage`` of the run, constant after, evaluated at the
  count of applied updates (0 for the first).
- The frozen backbone: only parameters that the trainable mask keeps and
  that require grad reach the optimizer.
- ``accumulate_grad_batches`` as ``optax.MultiSteps``: the running mean of k
  micro-batch gradients, one update per k, the schedule advancing once per
  update.
- ``load_optax_state``: resume from the optax state of a JAX checkpoint
  (``training.checkpoint.read_jax_opt_state``): the Adam moments through the
  weight bridge, the update count into the schedule and the bias
  correction, and ``MultiSteps``' pending micro-steps.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from nvblox_mindmap_torch.models.weights import flax_paths, flax_to_state_dict


def _decays(path: Sequence[str]) -> bool:
    """The JAX package's rule on a flax path: no decay for biases and
    LayerNorm parameters."""
    is_bias = path[-1] == "bias"
    is_layernorm = any("LayerNorm" in n for n in path) or path[-1] in ("scale", "offset")
    return not (is_bias or is_layernorm)


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True, by parameter name, where weight decay applies."""
    return {name: _decays(path) for name, path in flax_paths(model).items()}


def frozen_feature_extractor_mask(model: nn.Module, fpn_trainable: bool = True
                                  ) -> Dict[str, bool]:
    """True, by parameter name, where a parameter is TRAINABLE: everything
    but the vision backbone (``feature_extractor``), whose FPN trains when
    ``fpn_trainable``."""
    mask = {}
    for name, path in flax_paths(model).items():
        mask[name] = ("feature_extractor" not in path
                      or (fpn_trainable and "fpn" in path))
    return mask


def linear_lr_schedule(
    initial_learning_rate: float,
    end_factor: float,
    total_iters: int,
    convergence_percentage: float = 0.75,
) -> Callable[[int], float]:
    """LinearLR: the learning rate after ``step`` applied updates, in the
    float32 arithmetic of the JAX package's schedule."""
    convergence_iter = np.float32(max(int(total_iters * convergence_percentage), 1))
    slope = np.float32(end_factor - 1.0)
    initial = np.float32(initial_learning_rate)

    def schedule(step: int) -> float:
        frac = np.minimum(np.float32(step) / convergence_iter, np.float32(1.0))
        return float(initial * (np.float32(1.0) + slope * frac))

    return schedule


class Optimizer:
    """AdamW on a model's trainable parameters, with the LinearLR schedule
    and gradient accumulation.

    Call ``step()`` after each micro-batch's backward pass and then
    ``zero_grad()``. ``step`` returns whether it applied an update. A
    trainable parameter that got no gradient (one the forward never reads)
    steps with a zero gradient, as it does under optax: weight decay still
    applies to it.
    """

    def __init__(
        self,
        model: nn.Module,
        initial_learning_rate: float = 1e-4,
        weight_decay: float = 5e-4,
        end_factor: float = 0.5,
        total_iters: int = 100_000,
        convergence_percentage: float = 0.75,
        accumulate_grad_batches: int = 1,
        trainable_mask: Optional[Dict[str, bool]] = None,
    ):
        if accumulate_grad_batches < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got "
                             f"{accumulate_grad_batches}")
        decay = decay_mask(model)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad and (trainable_mask is None or trainable_mask[n])]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if decay[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in named if not decay[n]], "weight_decay": 0.0},
        ]
        self.adamw = torch.optim.AdamW(groups, lr=initial_learning_rate, betas=(0.9, 0.999),
                                       eps=1e-8)
        self.schedule = linear_lr_schedule(initial_learning_rate, end_factor, total_iters,
                                           convergence_percentage)
        self.accumulate_grad_batches = accumulate_grad_batches
        self.count = 0  # applied updates: the schedule's step
        self.mini_step = 0
        self._acc: Optional[list] = None

    def step(self) -> bool:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        k = self.accumulate_grad_batches
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            # optax.MultiSteps' running (Welford) mean of the micro-batches.
            for acc, p in zip(self._acc, self.params):
                acc.add_((p.grad - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                return False
            for acc, p in zip(self._acc, self.params):
                p.grad.copy_(acc)
                acc.zero_()
            self.mini_step = 0
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return True

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self._acc, "names": list(self.names)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state was saved for other trainable parameters")
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self._acc = (None if state["acc"] is None else
                     [a.to(p.device) for a, p in zip(state["acc"], self.params)])

    def tensor_state(self) -> Dict[str, Any]:
        """The state as live tensors and numbers, named by parameter, for a
        checkpoint that loads in place (``training/orbax_checkpoint.py``):
        each parameter's Adam step and moments (zeros before the first
        update, as AdamW would make them), the accumulation buffers when
        accumulating, and the update and micro-step counts. After loading
        into them, ``load_tensor_state`` takes the counts back."""
        state: Dict[str, Any] = {"step": {}, "exp_avg": {}, "exp_avg_sq": {},
                                 "count": self.count, "mini_step": self.mini_step}
        for name, p in zip(self.names, self.params):
            adam = self.adamw.state[p]
            if not adam:
                adam.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                            exp_avg_sq=torch.zeros_like(p))
            for key in ("step", "exp_avg", "exp_avg_sq"):
                state[key][name] = adam[key]
        if self.accumulate_grad_batches > 1:
            if self._acc is None:  # zeros, as an update leaves them
                self._acc = [torch.zeros_like(p) for p in self.params]
            state["acc"] = dict(zip(self.names, self._acc))
        return state

    def load_tensor_state(self, state: Dict[str, Any]) -> None:
        """The counts of a ``tensor_state`` loaded in place."""
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def load_optax_state(self, state: Any) -> None:
        """Take the state of the JAX package's optimizer chain (optax's
        ``adamw`` with a decay mask, the frozen-backbone ``masked``
        ``set_to_zero``, and ``MultiSteps`` around both when accumulating),
        as ``read_jax_opt_state`` gives it."""
        tensors = self.tensor_state()
        fill_tensor_state_from_optax(tensors, state)
        self.load_tensor_state(tensors)


def fill_tensor_state_from_optax(tensors: Dict[str, Any], state: Any) -> None:
    """Write an optax state (a tree of ``training.checkpoint.OPTAX_STATES``
    stand-ins) into an ``Optimizer.tensor_state()`` in place: the Adam
    moments by parameter name through the weight bridge, the update count
    (the schedule's step and Adam's bias correction), and ``MultiSteps``'
    pending micro-steps and running mean. Raises on a state of another
    chain or other parameters."""
    multi = state if type(state).__name__ == "MultiStepsState" else None
    if (multi is not None) != ("acc" in tensors):
        raise ValueError(f"a {'MultiSteps' if multi is not None else 'plain'} optax "
                         f"state for an optimizer {'with' if 'acc' in tensors else 'without'} "
                         "gradient accumulation")
    chain = state if multi is None else multi.inner_opt_state
    adam = _find_state(chain, "ScaleByAdamState")
    if adam is None:
        raise ValueError("the optax state holds no ScaleByAdamState")
    schedule = _find_state(chain, "ScaleByScheduleState")
    count = int(adam.count)
    if schedule is not None and int(schedule.count) != count:
        raise ValueError(f"optax counts differ: adam {count}, schedule "
                         f"{int(schedule.count)}")
    moments = {"exp_avg": flax_to_state_dict(adam.mu),
               "exp_avg_sq": flax_to_state_dict(adam.nu)}
    if multi is not None:
        moments["acc"] = flax_to_state_dict(multi.acc_grads)
    for key, source in moments.items():
        for name, target in tensors[key].items():
            if name not in source or source[name].shape != target.shape:
                raise ValueError(f"{name}: optax {key} "
                                 f"{tuple(source[name].shape) if name in source else 'missing'}"
                                 f" != parameter {tuple(target.shape)}")
            target.copy_(source[name])
    for step in tensors["step"].values():
        step.fill_(float(count))
    tensors["count"] = count
    tensors["mini_step"] = int(multi.mini_step) if multi is not None else 0


def _find_state(tree: Any, name: str) -> Any:
    """The first optax state of class ``name`` in a chain's nested tuples."""
    if type(tree).__name__ == name:
        return tree
    if isinstance(tree, tuple):
        for item in tree:
            found = _find_state(item, name)
            if found is not None:
                return found
    return None
