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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from portbench.reference.models.weights import flax_paths


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
