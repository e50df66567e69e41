"""Denoising-diffusion schedulers (DDPM / DDIM) as closed-form torch tables.

Port of ``nvblox_mindmap_tpu/ops/schedulers.py``. The beta tables are built
in float64 numpy and cast to float32, as the JAX package does; the step rules
follow diffusers' DDPMScheduler and DDIMScheduler at the upstream model's
call sites:

- position schedule ``scaled_linear``, rotation ``squaredcos_cap_v2``;
- ``leading`` and ``trailing`` timestep spacing;
- DDIM uses the clipped x0 with the raw predicted eps;
- DDPM uses the ``fixed_small`` variance and adds no noise at t = 0;
- ``add_noise`` is the forward process the training loss draws from.

Unlike the JAX version, ``step`` takes its noise as a tensor: torch cannot
reproduce ``jax.random`` streams, so the sampler draws (or is handed) the
noise and parity tests pass the JAX draws in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def make_betas(schedule: str, num_timesteps: int, beta_start: float = 1e-4,
               beta_end: float = 0.02) -> np.ndarray:
    """Beta tables for the two schedules the model uses (float64)."""
    if schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps, dtype=np.float64)
            ** 2
        )
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        i = np.arange(num_timesteps, dtype=np.float64)
        betas = 1.0 - alpha_bar((i + 1) / num_timesteps) / alpha_bar(i / num_timesteps)
        return np.minimum(betas, 0.999)
    raise ValueError(f"Unknown beta schedule: {schedule}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Scheduler tables (float32 numpy); ``kind`` selects the step rule.

    The tables stay on the host: a step's coefficients are float32 scalars
    computed there, in the same float32 arithmetic as the JAX package, and
    enter the device math as Python numbers, so a step launches only the
    tensor ops it needs.
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    kind: str
    clip_sample: bool
    clip_range: float

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]

    def timesteps(self, num_inference_steps: Optional[int] = None,
                  spacing: str = "leading") -> np.ndarray:
        """Descending inference timesteps (int64 numpy).

        ``leading`` (diffusers' default): [0, r, 2r, ...] reversed, so the
        chain starts at t = T - r. ``trailing``: [T-1, T-1-r, ...], starting
        where the initial sample really is pure noise.
        """
        T = self.num_train_timesteps
        n = num_inference_steps or T
        if n > T:
            raise ValueError(f"{n} inference steps exceed {T} train timesteps")
        step_ratio = T // n
        if spacing == "leading":
            ts = (np.arange(0, n) * step_ratio).round().astype(np.int64)[::-1]
        elif spacing == "trailing":
            ts = np.arange(T, 0, -step_ratio).round().astype(np.int64) - 1
        else:
            raise ValueError(f"unknown timestep spacing: {spacing!r}")
        return ts.copy()

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """Forward-process noising: sqrt(abar_t) x0 + sqrt(1 - abar_t) eps.

        ``t`` is a (B,) integer tensor on x0's device and broadcasts over the
        trailing dims of x0. The square roots are taken in float32 on the
        device, as the JAX package takes them.
        """
        abar = torch.as_tensor(self.alphas_cumprod, device=x0.device)[t.long()]
        shape = (x0.shape[0],) + (1,) * (x0.dim() - 1)
        sqrt_abar = torch.sqrt(abar).reshape(shape).to(x0.dtype)
        sqrt_1m = torch.sqrt(1.0 - abar).reshape(shape).to(x0.dtype)
        return sqrt_abar * x0 + sqrt_1m * noise

    def _alpha_bar(self, t: int) -> np.float32:
        return np.float32(1.0) if t < 0 else self.alphas_cumprod[t]

    def step(self, eps: torch.Tensor, t: int, sample: torch.Tensor,
             noise: Optional[torch.Tensor] = None,
             prev_t: Optional[int] = None) -> torch.Tensor:
        """One reverse-diffusion step x_t -> x_{prev_t}.

        ``t`` and ``prev_t`` (default t - 1) are Python ints. For DDPM,
        ``noise`` (shaped like ``sample``) adds the stochastic variance term;
        None gives the deterministic mean. DDIM ignores ``noise`` (eta = 0).
        """
        if prev_t is None:
            prev_t = t - 1
        one = np.float32(1.0)
        abar_t = self._alpha_bar(t)
        abar_prev = self._alpha_bar(prev_t)
        x0 = (sample - float(np.sqrt(one - abar_t)) * eps) / float(np.sqrt(abar_t))
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_range, self.clip_range)

        if self.kind == "ddim":
            # diffusers DDIMScheduler.step with use_clipped_model_output
            # False: the x0 term uses the CLIPPED x0, the direction term the
            # RAW predicted eps.
            return (float(np.sqrt(abar_prev)) * x0
                    + float(np.sqrt(one - abar_prev)) * eps)

        # DDPM posterior mean.
        alpha_t = abar_t / abar_prev
        beta_t = one - alpha_t
        beta_prod_t = one - abar_t
        beta_prod_prev = one - abar_prev
        x0_coeff = np.sqrt(abar_prev) * beta_t / beta_prod_t
        xt_coeff = np.sqrt(alpha_t) * beta_prod_prev / beta_prod_t
        prev = float(x0_coeff) * x0 + float(xt_coeff) * sample

        if noise is not None and t > 0:
            # variance_type="fixed_small": posterior variance, clamped.
            variance = max(beta_prod_prev / beta_prod_t * beta_t, np.float32(1e-20))
            prev = prev + float(np.sqrt(variance)) * noise
        return prev


def make_schedule(beta_schedule: str, num_train_timesteps: int = 100,
                  kind: str = "ddpm", clip_sample: bool = True,
                  clip_range: float = 1.0) -> DiffusionSchedule:
    betas = make_betas(beta_schedule, num_train_timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        betas=betas.astype(np.float32),
        alphas_cumprod=alphas_cumprod.astype(np.float32),
        kind=kind,
        clip_sample=clip_sample,
        clip_range=clip_range,
    )
