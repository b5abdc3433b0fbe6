"""Forward + reverse probability-flow ODE log-likelihood in sigma space
(Stable Diffusion; port of ``superdiff_tpu/eval/nll.py``, the reference's
``get_ll_ode`` / ``get_ll_ode_guidance``, ``clip_eval.py:161-285``).

A data-space latent is carried forward along the probability-flow ODE to
the sigma-max endpoint, scored under the Gaussian base measure, then
integrated back while the continuity equation accumulates ``dlog q``: the
full density estimate that checks the Itô estimator. JAX runs both loops
as ``lax.scan`` programs; here they are Python loops over the grid, with
the step scalars float32 on the host as in JAX.

The divergence is a Hutchinson estimate from one ``torch.func.jvp``
through the velocity: on the card every kernel's primal is the kernel and
its tangent its plain version (the kernels' ``jvp``). JAX draws each
step's Rademacher probe from ``fold_in(key, i)`` (forward) and
``fold_in(key, n + i)`` (reverse), which torch cannot reproduce, so
``ode_nll`` takes all 2n probes injected, or draws them from a
``torch.Generator`` in that order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core import ito
from ..core.schedules import SigmaGrid


def _event_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.float(), dim=tuple(range(1, x.ndim)))


def gaussian_base_logp(latents_unit: torch.Tensor, init_noise_sigma: float) -> torch.Tensor:
    """log N(x; 0, init_noise_sigma^2 I) with the reference's normalization
    convention (``clip_eval.py:194-196``); float32 (B,)."""
    d = math.prod(latents_unit.shape[1:])
    f32 = dict(dtype=torch.float32, device=latents_unit.device)
    s = torch.tensor(init_noise_sigma, **f32)
    ll = -d / 2.0 * (torch.log(torch.tensor(2 * math.pi, **f32))
                     - torch.log(torch.tensor(init_noise_sigma**2, **f32)))
    sq = torch.sum((latents_unit * s.to(latents_unit.dtype)) ** 2,
                   dim=tuple(range(1, latents_unit.ndim))).float()
    return ll - (1.0 / init_noise_sigma**2) * sq


def ode_nll(
    vel_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    ctx: torch.Tensor,
    latents0: torch.Tensor,
    grid: SigmaGrid,
    *,
    probes: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    guidance: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None,
) -> dict:
    """Round-trip ODE log-likelihood of data-space latents.

    ``vel_fn(x, t, sigma, ctx)`` is the velocity oracle; ``t`` and
    ``sigma`` come as 0-d float32 tensors on the host. With ``guidance`` =
    (ctx_obj, ctx_unc, g) the trajectory integrates the CFG field; the
    forward pass leaves ``ll`` as it is and the reverse pass tracks the
    conditional model, its divergence under ``ctx_obj`` plus the
    correction term (``get_ll_ode_guidance``). ``probes``: the 2n
    Rademacher probes of latents0's shape, forward steps first (JAX's
    draws in the tests); otherwise drawn from ``generator`` on the
    latents' device, one a step in that order.

    Returns a dict: ``ll`` (base measure included), ``ll_path``,
    ``ll_forward_path``, ``ll_base`` (float32 (B,)) and ``latents_end``.
    """
    timesteps, sigmas = grid.as_arrays()
    n = timesteps.shape[0]
    dev, dtype = latents0.device, latents0.dtype

    def probe(k):
        if probes is not None:
            return torch.as_tensor(probes[k], dtype=dtype, device=dev)
        return ito.rademacher(latents0.shape, generator, dtype, dev)

    def div_vel(x, t, sigma, c, z):
        val, tan = torch.func.jvp(lambda _x: vel_fn(_x, t, sigma, c), (x,), (z,))
        return val, -_event_sum(z * tan)

    with torch.no_grad():
        x = latents0
        ll_fwd = torch.zeros(latents0.shape[0], dtype=torch.float32, device=dev)
        for i in range(n):
            j = n - 1 - i  # the reversed grid: sigma upward
            sigma, dsigma, t = sigmas[j], sigmas[j] - sigmas[j + 1], timesteps[j]
            z = probe(i)
            if guidance is None:
                vf, div = div_vel(x, t, sigma, ctx, z)
                x = x + dsigma * vf
                ll_fwd = ll_fwd - torch.abs(dsigma) * div
            else:
                ctx_obj, ctx_unc, g = guidance
                v_obj = vel_fn(x, t, sigma, ctx_obj)
                v_unc = vel_fn(x, t, sigma, ctx_unc)
                x = x + dsigma * (v_unc + g * (v_obj - v_unc))

        x_unit = x / grid.init_noise_sigma
        ll_q0 = gaussian_base_logp(x_unit, grid.init_noise_sigma)
        x = x_unit * grid.init_noise_sigma

        ll = torch.zeros(latents0.shape[0], dtype=torch.float32, device=dev)
        for i in range(n):
            sigma, dsigma, t = sigmas[i], sigmas[i + 1] - sigmas[i], timesteps[i]
            z = probe(n + i)
            if guidance is None:
                vf, div = div_vel(x, t, sigma, ctx, z)
                x = x + dsigma * vf
                ll = ll - torch.abs(dsigma) * div
            else:
                ctx_obj, ctx_unc, g = guidance
                v_obj, div_obj = div_vel(x, t, sigma, ctx_obj, z)
                v_unc = vel_fn(x, t, sigma, ctx_unc)
                vf = v_unc + g * (v_obj - v_unc)
                x = x + dsigma * vf
                corr = _event_sum((-v_obj / sigma) * (v_obj - vf))
                ll = ll + (-torch.abs(dsigma) * div_obj - torch.abs(dsigma) * corr)
    return {
        "ll": ll + ll_q0,
        "ll_path": ll,
        "ll_forward_path": ll_fwd,
        "ll_base": ll_q0,
        "latents_end": x,
    }
