"""The superposition sampler: N models, one joint reverse trajectory (port of
``superdiff_tpu/core/superpose.py``).

The JAX package runs the trajectory as one ``lax.scan``; here it is a
Python loop over the steps, each one stacked score call plus an epilogue:

* SDE + OR: ``fused_sde_step``, the kernel on CUDA tensors and its plain
  version on CPU tensors;
* SDE + avg: the averaged field with Euler-Maruyama noise;
* ODE: one ``torch.func.jvp`` through the stacked oracle with a single
  shared Rademacher probe gives all N Hutchinson divergences.

Noise is injected or drawn: ``superpose`` takes the per-step unit normals
(SDE) or Rademacher probes (ODE) as ``noise`` (so tests can hand in the JAX
package's threefry draws), or draws them from an explicit
``torch.Generator``. The step scalars (``t = t_1 - i dt``, ``dlog_alpha_dt``,
``beta``, ``sigma``) are float32 values computed on the host, as JAX
computes them, so no step reads a device scalar. Running log-densities are
fp32 and max-renormalised every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.fused_step import fused_sde_step
from . import ito
from .kappa import or_weights

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (t, x[B,*e]) -> (N, B, *e)


@dataclasses.dataclass(frozen=True)
class SuperposeConfig:
    """Configuration of the joint reverse sampler; the reference's eval
    defaults: 200 steps (dt = 5e-3), SDE, OR at hard-max temperature 1e6."""

    n_steps: int = 200
    t_1: float = 1.0
    mode: str = "sde"  # "sde" (Euler-Maruyama) | "ode" (probability flow)
    operator: str = "or"  # "or" | "avg"
    or_temperature: float = 1e6
    score_eps: float = 1e-3

    @property
    def dt(self) -> float:
        return self.t_1 / self.n_steps


def _weights(logq: torch.Tensor, cfg: SuperposeConfig, n_models: int) -> torch.Tensor:
    if cfg.operator == "or":
        return or_weights(logq, cfg.or_temperature)
    if cfg.operator == "avg":
        return torch.full_like(logq, 1.0 / n_models)
    raise ValueError(f"unknown operator: {cfg.operator}")


def _mix(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the model axis: (B, N) x (N, B, *e) -> (B, *e)."""
    w = weights.T.reshape(weights.shape[::-1] + (1,) * (stacked.ndim - 2))
    return torch.sum(w * stacked, dim=0)


def sde_step(eps, x, logq, t, dt, score_fn: ScoreFn, schedule, cfg: SuperposeConfig):
    """One Euler-Maruyama step of the joint reverse SDE under OR with the
    unit normals ``eps`` (``cifar/dynamics.py:115-136``): mix the
    sigma-scaled scores with the OR weights, step, update every model's
    running log-density with the divergence-free Itô estimator, all in
    ``fused_sde_step``."""
    return fused_sde_step(score_fn(t, x), x, eps, logq, schedule.dlog_alpha_dt(t),
                          schedule.beta(t), schedule.sigma(t), dt,
                          temperature=cfg.or_temperature)


def ode_step(probe, x, logq, t, dt, score_fn: ScoreFn, schedule, cfg: SuperposeConfig):
    """One probability-flow step with the Rademacher ``probe``
    (``cifar/dynamics.py:74-95``): one JVP through the stacked oracle gives
    the scores and all N divergence estimates."""
    sscores, divs = ito.hutchinson_div(lambda _x: score_fn(t, _x), x, probe)
    da, beta = schedule.dlog_alpha_dt(t), schedule.beta(t)
    vfs = da * x[None] - beta * sscores
    dx = -dt * _mix(_weights(logq, cfg, sscores.shape[0]), vfs)
    dlogq = ito.dlogq_ode_vp(sscores, divs, x, dx, t, dt, schedule, cfg.score_eps)
    return x + dx, ito.renormalize_logq(logq + dlogq)


def avg_sde_step(eps, x, logq, t, dt, score_fn: ScoreFn, schedule, cfg: SuperposeConfig):
    """Averaged-field baseline, stochastic (``cifar/dynamics.py:155-171``)."""
    sscores = score_fn(t, x)
    da, beta, sigma = schedule.dlog_alpha_dt(t), schedule.beta(t), schedule.sigma(t)
    vfs = da * x[None] - 2.0 * beta * sscores
    dx = -dt * torch.mean(vfs, dim=0)
    dx = dx + torch.sqrt(2.0 * sigma * beta * dt) * eps
    return x + dx, logq


@torch.no_grad()
def superpose(
    x_init: torch.Tensor,
    score_fn: ScoreFn,
    schedule,
    cfg: SuperposeConfig,
    n_models: int,
    *,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Run the joint reverse trajectory.

    Args:
      x_init: (B, *event) initial latents.
      score_fn: stacked oracle ``(t, x) -> (N, B, *event)`` of sigma-scaled
        scores (the CIFAR nets' ``-eps_hat`` convention).
      schedule: a ``VPSchedule``-like object.
      cfg: sampler configuration.
      n_models: N.
      noise: optional per-step draws, ``noise[i]`` (B, *event): unit normals
        (SDE) or a Rademacher probe (ODE). Otherwise drawn from ``generator``.

    Returns:
      (x_0, logq (B, N) fp32, nfe).
    """
    steps = {("sde", "or"): sde_step, ("sde", "avg"): avg_sde_step,
             ("ode", "or"): ode_step, ("ode", "avg"): ode_step}
    if (cfg.mode, cfg.operator) not in steps:
        raise ValueError(f"unknown mode / operator: {cfg.mode} / {cfg.operator}")
    step = steps[cfg.mode, cfg.operator]
    dev = x_init.device
    x = x_init
    logq = torch.zeros((x.shape[0], n_models), dtype=torch.float32, device=dev)
    # float32 host scalars, in the JAX scan's order of operations
    dt = torch.tensor(cfg.dt, dtype=torch.float32)
    for i in range(cfg.n_steps):
        t = cfg.t_1 - torch.tensor(i, dtype=torch.float32) * dt
        if noise is not None:
            z = torch.as_tensor(noise[i], dtype=x.dtype, device=dev)
        elif cfg.mode == "ode":
            z = ito.rademacher(x.shape, generator, x.dtype, dev)
        else:
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=dev)
        x, logq = step(z, x, logq, t, dt, score_fn, schedule, cfg)
    nfe = cfg.n_steps * (2 if cfg.mode == "ode" else 1)
    return x, logq, nfe

