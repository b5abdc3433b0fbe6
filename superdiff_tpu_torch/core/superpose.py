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
computes them. Running log-densities are fp32 and max-renormalised every
step.

SDE + OR runs on static buffers (``_SdeOrLoop``): the scalars go to the
card once as a per-step table, the unit normals are drawn before the loop
(the same draws, in the same order, as one per step), and each step reads
both through a device step index. On the card the step is captured in a
CUDA graph after an eager step 0 and replayed (``capture=None`` or
``True``), the port's counterpart of the JAX ``lax.scan``; a
``SuperposeSampler`` keeps the captured loop for its next run of the same
shapes. ``capture=False`` calls the same step eagerly, as the CPU does. The
other modes run eagerly, step by step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.fused_step import fused_sde_step
from ..utils import profiling
from . import ito
from .capture import StepLoop, want_capture
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


def sde_step(eps, x, logq, t, dt, score_fn: ScoreFn, schedule, cfg: SuperposeConfig):
    """One Euler-Maruyama step of the joint reverse SDE under OR
    (``cifar/dynamics.py:115-136``), as one step of the captured loop runs
    it: ``fused_sde_step`` on the stacked scores (the kernel on the card,
    its plain version on the CPU) mixes them with the OR weights, steps,
    and updates every model's log-density with the Itô estimator. ``eps``
    the step's unit normals; returns (x + dx, renormalised logq)."""
    da, beta, sigma = schedule.dlog_alpha_dt(t), schedule.beta(t), schedule.sigma(t)
    return fused_sde_step(score_fn(t, x), x, eps, logq, da, beta, sigma, dt,
                          temperature=cfg.or_temperature)


def avg_sde_step(eps, x, logq, t, dt, score_fn: ScoreFn, schedule, cfg: SuperposeConfig):
    """Averaged-field baseline, stochastic (``cifar/dynamics.py:155-171``)."""
    sscores = score_fn(t, x)
    da, beta, sigma = schedule.dlog_alpha_dt(t), schedule.beta(t), schedule.sigma(t)
    vfs = da * x[None] - 2.0 * beta * sscores
    dx = -dt * torch.mean(vfs, dim=0)
    dx = dx + torch.sqrt(2.0 * sigma * beta * dt) * eps
    return x + dx, logq


def sde_or_step_table(schedule, cfg: SuperposeConfig) -> torch.Tensor:
    """(steps, 5) fp32 rows (t, dlog_alpha_dt, beta, sigma, dt), each from
    the host scalars by the ops the step loop applies to them, one step at a
    time, so every value has its bits."""
    dt = torch.tensor(cfg.dt, dtype=torch.float32)
    rows = []
    for i in range(cfg.n_steps):
        t = cfg.t_1 - torch.tensor(i, dtype=torch.float32) * dt
        rows.append(torch.stack([t, torch.as_tensor(schedule.dlog_alpha_dt(t)),
                                 torch.as_tensor(schedule.beta(t)),
                                 torch.as_tensor(schedule.sigma(t)), dt]))
    return torch.stack(rows).to(torch.float32)


class _SdeOrLoop(StepLoop):
    """The SDE + OR trajectory on static buffers. ``step()`` is one
    Euler-Maruyama step of the joint reverse SDE under OR
    (``cifar/dynamics.py:115-136``): it takes the step index ``idx`` from
    device memory, its row of the scalar table and its unit normals, mixes
    the sigma-scaled scores with the OR weights, steps and updates every
    model's running log-density with the divergence-free Itô estimator, all
    in ``fused_sde_step``; x and logq are written in place and ``idx``
    advanced, so the same launches serve every step, eagerly or replayed
    from a graph."""

    def __init__(self, score_fn: ScoreFn, cfg: SuperposeConfig, table, x_init, zs, n_models):
        dev = x_init.device
        self.score_fn, self.cfg, self.table = score_fn, cfg, table
        # the inputs are copied: a kept loop loads the next run's over them
        self.x_init, self.zs = x_init.clone(), zs.clone()
        self.x = x_init.clone()
        self.logq = torch.zeros((x_init.shape[0], n_models), dtype=torch.float32, device=dev)
        self.idx = torch.zeros((1,), dtype=torch.long, device=dev)
        profiling.count("loops_built")

    def fits(self, x_init) -> bool:
        """Whether a run from ``x_init`` can replay this loop: the same
        shape, dtype and device."""
        return (x_init.shape == self.x_init.shape and x_init.dtype == self.x_init.dtype
                and x_init.device == self.x_init.device)

    def load(self, x_init, zs):
        with profiling.span("load"):
            self.x_init.copy_(x_init)
            self.zs.copy_(zs)

    def reset(self):
        self.x.copy_(self.x_init)
        self.logq.zero_()
        self.idx.zero_()

    def step(self):
        t, da, beta, sigma, dt = self.table.index_select(0, self.idx)[0].unbind()
        eps = self.zs.index_select(0, self.idx)[0]
        new_x, new_logq = fused_sde_step(self.score_fn(t, self.x), self.x, eps, self.logq, da,
                                         beta, sigma, dt, temperature=self.cfg.or_temperature)
        self.x.copy_(new_x)
        self.logq.copy_(new_logq)
        self.idx += 1

    def run(self, capture: bool):
        """Every step from the start; returns (x_0, logq), copies."""
        self.advance(self.table.shape[0], capture)
        return self.x.clone(), self.logq.clone()


class SuperposeSampler:
    """The joint reverse trajectory of one stacked oracle under one config:
    :func:`superpose` runs one, ``pipelines.cifar.make_generator`` keeps
    one. Under SDE + OR on the card its captured step loop (static buffers
    and CUDA graph) stays here until a run of other shapes replaces it, so
    a later run of the same shapes replays every step."""

    def __init__(self, score_fn: ScoreFn, schedule, cfg: SuperposeConfig, n_models: int):
        self.score_fn, self.schedule, self.cfg, self.n_models = score_fn, schedule, cfg, n_models
        self.loop: Optional[_SdeOrLoop] = None

    @torch.no_grad()
    def __call__(self, x_init: torch.Tensor, *, noise: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 capture: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """One trajectory from ``x_init``; the arguments and the result as
        in :func:`superpose`. The call is a ``sample`` span; its noise stack
        and the kept loop's inputs are ``load`` spans."""
        with profiling.span("sample"):
            cfg, dev = self.cfg, x_init.device
            nfe = cfg.n_steps * (2 if cfg.mode == "ode" else 1)
            if (cfg.mode, cfg.operator) == ("sde", "or"):
                x, logq = self._sde_or(x_init, noise, generator,
                                       want_capture(capture, dev, "superpose"))
                return x, logq, nfe
            steps = {("sde", "avg"): avg_sde_step, ("ode", "or"): ode_step,
                     ("ode", "avg"): ode_step}
            if (cfg.mode, cfg.operator) not in steps:
                raise ValueError(f"unknown mode / operator: {cfg.mode} / {cfg.operator}")
            if capture:
                raise ValueError(f"capture=True: only sde / or runs as a captured step, not "
                                 f"{cfg.mode} / {cfg.operator}")
            x = x_init
            logq = torch.zeros((x.shape[0], self.n_models), dtype=torch.float32, device=dev)
            # float32 host scalars, in the JAX scan's order of operations
            dt = torch.tensor(cfg.dt, dtype=torch.float32)
            for i in profiling.steps(range(cfg.n_steps), "steps_eager"):
                t = cfg.t_1 - torch.tensor(i, dtype=torch.float32) * dt
                if noise is not None:
                    z = torch.as_tensor(noise[i], dtype=x.dtype, device=dev)
                elif cfg.mode == "ode":
                    z = ito.rademacher(x.shape, generator, x.dtype, dev)
                else:
                    z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=dev)
                x, logq = steps[cfg.mode, cfg.operator](z, x, logq, t, dt, self.score_fn,
                                                        self.schedule, cfg)
            return x, logq, nfe

    def _sde_or(self, x_init, noise, generator, capture: bool):
        cfg, dev = self.cfg, x_init.device
        with profiling.span("load"):
            if noise is not None:
                zs = torch.stack([torch.as_tensor(noise[i], dtype=x_init.dtype, device=dev)
                                  for i in range(cfg.n_steps)])
            else:
                # one draw a step, in order, as the step-by-step loop draws them
                zs = torch.empty((cfg.n_steps,) + tuple(x_init.shape), dtype=x_init.dtype,
                                 device=dev)
                for i in range(cfg.n_steps):
                    zs[i] = torch.randn(x_init.shape, generator=generator,
                                        dtype=x_init.dtype, device=dev)
        if capture and self.loop is not None and self.loop.fits(x_init):
            self.loop.load(x_init, zs)
            return self.loop.run(capture)
        if capture:
            self.loop = None  # its graph's memory goes before the next is captured
        loop = _SdeOrLoop(self.score_fn, cfg, sde_or_step_table(self.schedule, cfg).to(dev),
                          x_init, zs, self.n_models)
        if capture:
            self.loop = loop
        return loop.run(capture)


def superpose(
    x_init: torch.Tensor,
    score_fn: ScoreFn,
    schedule,
    cfg: SuperposeConfig,
    n_models: int,
    *,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    capture: Optional[bool] = None,
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
      capture: SDE + OR only: replay one step captured in a CUDA graph
        (``None``: on the card, not on the CPU; ``True`` on CPU tensors or
        another mode raises); ``False`` runs the same step eagerly. A
        :class:`SuperposeSampler` keeps the captured loop between runs.

    Returns:
      (x_0, logq (B, N) fp32, nfe).
    """
    return SuperposeSampler(score_fn, schedule, cfg, n_models)(
        x_init, noise=noise, generator=generator, capture=capture)


def stack_score_fns(fns: Sequence[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]
                    ) -> ScoreFn:
    """A list of per-model score functions ``f(t, x) -> (B, *event)`` as one
    stacked oracle ``(t, x) -> (N, B, *event)``: heterogeneous models (other
    architectures, other inputs), one call each; same-architecture modules
    go through ``models.ensemble.make_stacked_score_fn``."""
    fns = list(fns)

    def score_fn(t, x):
        return torch.stack([f(t, x) for f in fns], dim=0)

    return score_fn
