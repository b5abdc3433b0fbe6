"""Mixing-weight (kappa) policies (port of ``superdiff_tpu/core/kappa.py``).

The OR policies (two-model ``kappa_or`` of the SD and protein stacks,
N-model ``or_weights`` of the CIFAR stack), the closed-form AND policies of
the sigma-space SDE and ODE, and the protein stack's generic AND policy with
its normalized-sigma lift. Like the JAX package, every policy works on
float32 accumulators: the OR softmax at high temperature is an argmax in
disguise and must not see bf16 rounding noise.
"""

from __future__ import annotations

import torch


def or_weights(logq: torch.Tensor, temperature: float = 1e6) -> torch.Tensor:
    """N-model OR weights: ``softmax(T * logq)`` along the last axis; with the
    reference's T = 1e6 a smooth argmax over the running log-likelihoods
    (``cifar/dynamics.py:90,124``). (B, N) -> (B, N) fp32."""
    return torch.softmax(temperature * logq.float(), dim=-1)


def kappa_or(ll_a: torch.Tensor, ll_b: torch.Tensor, temperature: float = 1.0,
             logp: float = 0.0) -> torch.Tensor:
    """Two-model OR kappa, the weight on model *a*:
    ``softmax([T*(ll_a + logp), T*ll_b])[0]``. Same shape as the inputs."""
    a = temperature * (ll_a.float() + logp)
    b = temperature * ll_b.float()
    m = torch.maximum(a, b)
    ea, eb = torch.exp(a - m), torch.exp(b - m)
    return ea / (ea + eb)


def _sum_event(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.float(), dim=tuple(range(1, x.ndim)))


def kappa_and_sde(vel_a, vel_b, dx_ind, sigma, dsigma, guidance_scale: float,
                  num_steps: int, lift: float = 0.0) -> torch.Tensor:
    """Closed-form AND kappa (the weight on model *a*) for the sigma-space SDE:

      kappa = [ sum(|dsigma| (v_b - v_a)(v_b + v_a)) - sum(dx_ind (v_a - v_b))
                + sigma * lift / num_steps ] / [ 2 dsigma g sum((v_a - v_b)^2) ]

    ``dx_ind`` is the step model b alone would have taken, noise included.
    vel_* and dx_ind (B, *event); returns (B,). Identical velocities give
    0 / 0, as in the JAX package.
    """
    d = vel_a - vel_b
    num = abs(dsigma) * _sum_event((vel_b - vel_a) * (vel_b + vel_a))
    num = num - _sum_event(dx_ind * d) + sigma * lift / num_steps
    return num / (2.0 * dsigma * guidance_scale * _sum_event(d**2))


def kappa_and_ode(vel_a, vel_b, div_a, div_b, vel_uncond, sigma, dsigma,
                  guidance_scale: float, num_steps: int, lift: float = 0.0) -> torch.Tensor:
    """Closed-form AND kappa for the sigma-space probability-flow ODE;
    ``div_*`` (B,) are the Hutchinson divergence terms in the reference's
    sign. Returns (B,)."""
    d = vel_a - vel_b
    base = vel_uncond + guidance_scale * (vel_b - vel_uncond)
    num = sigma * (div_a - div_b) + _sum_event(d * (vel_a + vel_b))
    num = num + lift / dsigma * sigma / num_steps
    num = num - _sum_event(d * base)
    return num / (guidance_scale * _sum_event(d**2))


def kappa_and_generic(score_a, score_b, dx_ind, f_x, beta_t, dt, num_steps: int,
                      logp: float = 0.0, sigma_weight=None) -> torch.Tensor:
    """Closed-form AND kappa for a generic reverse SDE component (the
    protein ``kappa_AND``): equates the divergence-free dll increments of the
    two models; ``logp * sigma_weight / num_steps`` is the normalized-sigma
    lift. ``d = a - b`` is formed elementwise before any reduction, so fp32
    suffices where the reference takes fp64. score_* / dx_ind (B, *event),
    ``f_x`` the drift at x (0 for a driftless component); returns (B,).
    Identical scores (a zero denominator) make kappa irrelevant and give
    0.5, as the composition pipeline's AND does.
    """
    a = score_a.float()
    b = score_b.float()
    d = a - b
    kappa = -dt * beta_t * _sum_event(d * (a + b))
    kappa = kappa + _sum_event((dx_ind + dt * f_x) * d)
    den = 2.0 * dt * beta_t * _sum_event(d**2)
    safe = torch.clamp_min(den, 1e-12)
    out = -kappa / safe
    if sigma_weight is not None:
        out = out + (logp * sigma_weight / num_steps) / safe
    return torch.where(den > 1e-12, out, 0.5)


def normalized_log_sigma(sigma_t, sigma_min: float, sigma_max: float, dim: int):
    """Sigma-normalized lift weight of the protein AND operator:
    ``-0.5 dim log(sigma)`` min-max normalized to [0, 1] over the schedule's
    sigma range."""
    s = -0.5 * dim * torch.log(torch.as_tensor(sigma_t))
    lo = -0.5 * dim * torch.log(torch.as_tensor(sigma_max, dtype=torch.float32))
    hi = -0.5 * dim * torch.log(torch.as_tensor(sigma_min, dtype=torch.float32))
    return (s - lo) / (hi - lo)
