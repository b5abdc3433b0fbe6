"""Sigma grid for sigma-space sampling (port of ``superdiff_tpu/core/schedules.py``).

Only what the SD slice needs: the discrete DDPM cumulative-alpha table and
the ``EulerDiscrete`` sigma grid. The grid is built host-side in float64
with numpy, exactly as the JAX package builds it, and handed out as float32
tensors (``as_arrays``), as JAX's ``as_arrays`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


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
