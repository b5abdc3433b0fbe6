"""Noise schedules (port of ``superdiff_tpu/core/schedules.py``).

* ``VPSchedule`` / ``CosineVPSchedule``: the CIFAR stack's VP-SDE, frozen
  dataclasses of scalars whose methods are closed-form in ``t``. They work on
  Python floats (math) and on tensors (torch, in the tensor's dtype); the
  samplers pass 0-d float32 tensors, so the step scalars are float32, as
  the JAX package computes them.
* The discrete DDPM cumulative-alpha table and the ``EulerDiscrete`` sigma
  grid of the SD stack, built host-side in float64 with numpy, exactly as the
  JAX package builds them, and handed out as float32 tensors
  (``as_arrays``), as JAX's ``as_arrays`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


def _exp(t):
    return torch.exp(t) if isinstance(t, torch.Tensor) else math.exp(t)


def _log(t):
    return torch.log(t) if isinstance(t, torch.Tensor) else math.log(t)


def _expm1(t):
    return torch.expm1(t) if isinstance(t, torch.Tensor) else math.expm1(t)


@dataclasses.dataclass(frozen=True)
class VPSchedule:
    """Variance-preserving SDE with the reference's linear-sigma convention
    (``cifar/dynamics.py:15-27``): ``log_alpha(t) = -0.5 t b0 - 0.25 t^2
    (b1-b0)``, ``sigma(t) = t``, ``beta(t) = 1 + 0.5 t b0 + 0.5 t^2 (b1-b0)``.

    Forward kernel ``x_t = alpha(t) x_0 + sigma(t) eps``; the reverse SDE
    drift uses ``beta(t)`` as the score scaling.
    """

    beta_0: float = 0.1
    beta_1: float = 20.0

    def log_alpha(self, t):
        return -0.5 * t * self.beta_0 - 0.25 * t**2 * (self.beta_1 - self.beta_0)

    def alpha(self, t):
        return _exp(self.log_alpha(t))

    def log_sigma(self, t):
        return _log(t)

    def sigma(self, t):
        return t

    def dlog_alpha_dt(self, t):
        return -0.5 * self.beta_0 - 0.5 * t * (self.beta_1 - self.beta_0)

    def dlog_sigma_dt(self, t):
        return 1.0 / t

    def beta(self, t):
        """Score-drift coefficient ``sigma_t^2 d/dt log(sigma_t / alpha_t)``,
        as the reference's expanded polynomial."""
        return 1.0 + 0.5 * t * self.beta_0 + 0.5 * t**2 * (self.beta_1 - self.beta_0)

    def marginal(self, x0, eps, t):
        """Forward diffusion sample ``x_t`` given data and noise."""
        return self.alpha(t) * x0 + self.sigma(t) * eps


@dataclasses.dataclass(frozen=True)
class CosineVPSchedule(VPSchedule):
    """Standard VP-SDE sigma: ``sigma^2 = 1 - alpha^2`` (textbook variant)."""

    def log_sigma(self, t):
        var = -_expm1(-t * self.beta_0 - 0.5 * t**2 * (self.beta_1 - self.beta_0))
        return 0.5 * _log(var)

    def sigma(self, t):
        return _exp(self.log_sigma(t))

    def dlog_sigma_dt(self, t):
        b = self.beta_0 + t * (self.beta_1 - self.beta_0)
        e = _exp(-t * self.beta_0 - 0.5 * t**2 * (self.beta_1 - self.beta_0))
        return 0.5 * b * e / (1.0 - e)

    def beta(self, t):
        return self.sigma(t) ** 2 * (self.dlog_sigma_dt(t) - self.dlog_alpha_dt(t))


def ddpm_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> np.ndarray:
    """Discrete DDPM cumulative-alpha table (host-side, float64)."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    else:
        raise ValueError(f"unknown beta_schedule: {beta_schedule}")
    return np.cumprod(1.0 - betas)


@dataclasses.dataclass(frozen=True)
class SigmaGrid:
    """Sigma grid of diffusers' ``EulerDiscreteScheduler`` (linspace spacing).

    Attributes:
      timesteps: [n] UNet conditioning timesteps, descending.
      sigmas:    [n+1] sigma at each step, terminal 0 appended.
      init_noise_sigma: initial latent scale, ``sqrt(s_max^2 + 1)``.
    """

    timesteps: Tuple[float, ...]
    sigmas: Tuple[float, ...]
    init_noise_sigma: float

    @staticmethod
    def euler_discrete(
        num_inference_steps: int,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
    ) -> "SigmaGrid":
        ac = ddpm_alphas_cumprod(num_train_timesteps, beta_start, beta_end, beta_schedule)
        full_sigmas = np.sqrt((1.0 - ac) / ac)
        ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps, dtype=np.float64)[::-1]
        sig = np.interp(ts, np.arange(num_train_timesteps), full_sigmas)
        sig = np.concatenate([sig, [0.0]])
        init = float(np.sqrt(sig.max() ** 2 + 1.0))
        return SigmaGrid(
            timesteps=tuple(float(t) for t in ts),
            sigmas=tuple(float(s) for s in sig),
            init_noise_sigma=init,
        )

    def as_arrays(self, dtype=torch.float32, device="cpu"):
        """(timesteps [n], sigmas [n+1]) as tensors, float32 by default."""
        return (
            torch.tensor(self.timesteps, dtype=dtype, device=device),
            torch.tensor(self.sigmas, dtype=dtype, device=device),
        )
