"""Itô density estimators (port of ``superdiff_tpu/core/ito.py``: the
sigma-space forms of the SD stack, the VP forms of the CIFAR stack).

Along the reverse trajectory ``x + dx`` each model (or conditioning) i
defines a marginal density ``q_i``; these estimators give the running change
``dlog q_i``. The SDE forms need only the scores and the realized step; the
ODE form adds a Hutchinson divergence estimate from one Rademacher-probe JVP
(``torch.func.jvp``). All reductions run in float32 whatever the model's
compute dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _fsum(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.sum(x.float(), dim=dims)


def _event_dims(vels: torch.Tensor):
    """Event dims of an (N, B, *event) tensor."""
    return tuple(range(2, vels.ndim))


def dlogq_sde_sigma_space(vels, dx, sigma, dsigma):
    """``dll_i = sum(-|dsigma|/sigma * v_i^2 - dx * v_i / sigma)`` ("and"/"avg").

    vels (N, B, *event), dx (B, *event); returns (B, N).
    """
    out = _fsum(-abs(dsigma) / sigma * vels**2 - dx[None] * vels / sigma,
                _event_dims(vels))
    return out.T


def dlogq_sde_sigma_space_or(vels, dx, sigma, dsigma):
    """OR variant: ``dll_i = -sum(v_i * (dx + dsigma * v_i)) / sigma``.

    vels (N, B, *event), dx (B, *event); returns (B, N).
    """
    out = -_fsum(vels * (dx[None] + dsigma * vels), _event_dims(vels)) / sigma
    return out.T


def rademacher(shape, generator: Optional[torch.Generator] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Rademacher probe (+/-1) for Hutchinson divergence estimation, built as
    the reference builds it: ``randint(0, 2) * 2 - 1``."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=device)
    return bits.to(dtype) * 2.0 - 1.0


def hutchinson_div(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                   probe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(fn(x), sum(probe * J_fn(x) probe))`` over the event dims of ``x``,
    from one forward-mode JVP. ``fn`` maps x (B, *event) to (B, *event) or
    to a stack (N, B, *event); the divergences are then (B,) or (N, B)."""
    val, tangent = torch.func.jvp(fn, (x,), (probe,))
    return val, _fsum(tangent * probe, tuple(range(tangent.ndim - x.ndim + 1, tangent.ndim)))


def dlogq_sde_vp(sscores, x, dx, t, dt, schedule):
    """Discrete divergence-free ``dlog q_i`` for the VP reverse SDE
    (``cifar/dynamics.py:131-134``):

      dlogq_i = (f(x+dx) - v_i) (dt v_i + 2 dx + dt f(x+dx)) / (4 sigma beta)

    with ``f(y) = dlog_alpha/dt * y`` and ``v_i = f(x) - 2 beta s_i``.
    sscores (N, B, *event), x and dx (B, *event); returns (B, N) fp32.
    """
    da, beta, sigma = schedule.dlog_alpha_dt(t), schedule.beta(t), schedule.sigma(t)
    v = da * x[None] - 2.0 * beta * sscores
    f_next = da * (x + dx)[None]
    num = (f_next - v) * (dt * v + 2.0 * dx[None] + dt * f_next)
    return (_fsum(num, _event_dims(num)) / (4.0 * sigma * beta)).T


def dlogq_ode_vp(sscores, divs, x, dx, t, dt, schedule, score_eps: float = 1e-3):
    """Continuity-equation ``dlog q_i`` for the VP probability-flow ODE
    (``cifar/dynamics.py:86-94``):

      vf_i    = dlog_alpha_dt x - beta s_i
      dlogq_i = -dt beta div_i + < s_i / (sigma + eps), dx + dt vf_i >

    ``divs`` (N, B) are the Hutchinson estimates of each score's Jacobian
    trace; returns (B, N) fp32.
    """
    da, beta = schedule.dlog_alpha_dt(t), schedule.beta(t)
    vf = da * x[None] - beta * sscores
    div = -beta * divs
    grad_logq = sscores / (schedule.sigma(t) + score_eps)
    return (dt * div + _fsum(grad_logq * (dx[None] + dt * vf), _event_dims(vf))).T


def dlogq_ode_sigma_space(vels, divs, vf_mixed, sigma, dsigma):
    """Continuity-equation ``dlog q_i`` in sigma-space:

      dll_i = dsigma * ( div_i - < -v_i / sigma, v_i - vf_mixed > )

    with ``div_i`` in the reference's sign (``-(probe * jvp).sum``).
    vels (N, B, *event), divs (N, B), vf_mixed (B, *event); returns (B, N).
    """
    corr = _fsum((-vels / sigma) * (vels - vf_mixed[None]), _event_dims(vels))
    return (dsigma * (divs - corr)).T


def renormalize_logq(logq: torch.Tensor) -> torch.Tensor:
    """Subtract the per-sample max across models (``dynamics.py:94``); the OR
    softmax is invariant to the shift."""
    return logq - logq.max(dim=-1, keepdim=True).values
