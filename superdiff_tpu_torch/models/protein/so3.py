"""IGSO(3) diffuser with device-resident tables (port of
``superdiff_tpu/models/protein/so3.py``).

The isotropic Gaussian on SO(3) with the logarithmic sigma schedule
``sigma(t) = log(t e^{s_max} + (1-t) e^{s_min})``. The pdf / cdf /
score-norm tables are built once on the host in float64 numpy, as the JAX
package builds them, and move to the device as float32; score lookup and
inverse-CDF sampling are gathers on the device.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch


def igso3_tables(omegas: np.ndarray, sigma_grid: np.ndarray, L: int):
    """(f, d/d omega log f) of the truncated IGSO(3) power series over the
    (sigma, omega) grids, float64 (sigma reparameterized so t = sigma^2
    matches Brownian motion):

      f(omega; s) = sum_l (2l+1) e^{-l(l+1) s^2 / 2} sin((l+1/2) omega) / sin(omega/2)

    and its derivative by the quotient rule, divided by ``f + 1e-4``. The
    JAX package sums each sigma's terms elementwise; here the sigma-free
    trigonometric factors are formed once and the sums over l are one
    matrix product each (the same values up to float64 rounding)."""
    ls = np.arange(L)[None, :]
    om = omegas[:, None]
    hi = np.sin(om * (ls + 0.5))
    lo = np.sin(om / 2.0)
    dhi = (ls + 0.5) * np.cos(om * (ls + 0.5))
    dlo = 0.5 * np.cos(om / 2.0)
    coef = (2 * ls + 1) * np.exp(-ls * (ls + 1) * sigma_grid[:, None] ** 2 / 2.0)
    exp_vals = coef @ (hi / lo).T
    score = (coef @ ((lo * dhi - hi * dlo) / lo**2).T) / (exp_vals + 1e-4)
    return exp_vals, score


class SO3Diffuser:
    """IGSO(3) diffusion; the tables live on ``device``."""

    def __init__(self, min_sigma: float = 0.1, max_sigma: float = 1.5,
                 num_sigma: int = 1000, num_omega: int = 1000, L: int = 1000,
                 device="cuda"):
        self.min_sigma = float(min_sigma)
        self.max_sigma = float(max_sigma)
        self.num_sigma = num_sigma
        # e^{s_max}, e^{s_min} as the float32 values JAX's ``jnp.exp`` of the
        # Python floats gives (correctly rounded)
        self._exp_max = float(np.float32(np.exp(self.max_sigma)))
        self._exp_min = float(np.float32(np.exp(self.min_sigma)))
        omegas = np.linspace(0, np.pi, num_omega + 1)[1:]
        sigma_grid = np.asarray(
            [self._sigma_np(t) for t in np.linspace(0.0, 1.0, num_sigma)]
        )
        exp_vals, score_norm = igso3_tables(omegas, sigma_grid, L)
        pdf = exp_vals * (1 - np.cos(omegas)[None]) / np.pi
        cdf = pdf.cumsum(axis=-1) / num_omega * np.pi
        score_scaling = np.sqrt(
            np.abs((score_norm**2 * pdf).sum(-1) / pdf.sum(-1))
        ) / np.sqrt(3.0)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.omegas = dev(omegas)
        self.sigmas = dev(sigma_grid)
        self.cdf = dev(cdf)
        self.score_norm = dev(score_norm)
        self.score_scaling_table = dev(score_scaling)

    @property
    def device(self):
        return self.omegas.device

    def to(self, device) -> "SO3Diffuser":
        """A copy whose tables live on ``device``."""
        out = copy.copy(self)
        for name in ("omegas", "sigmas", "cdf", "score_norm", "score_scaling_table"):
            setattr(out, name, getattr(self, name).to(device))
        return out

    # -- schedule -------------------------------------------------------
    def _sigma_np(self, t: float) -> float:
        return float(
            np.log(t * np.exp(self.max_sigma) + (1 - t) * np.exp(self.min_sigma))
        )

    def sigma(self, t):
        """sigma(t) in float32, each op as the JAX package takes it."""
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.log(t * self._exp_max + (1.0 - t) * self._exp_min)

    def diffusion_coef(self, t):
        """g(t) for the logarithmic schedule."""
        s = self.sigma(t)
        return torch.sqrt(2.0 * (self._exp_max - self._exp_min) * s / torch.exp(s))

    def t_to_idx(self, t):
        """Continuous t -> index into the sigma grid (``np.digitize(sigma,
        grid) - 1``): ``searchsorted(side="right")`` on the float32 sigma."""
        s = self.sigma(t).to(self.device)
        idx = torch.searchsorted(self.sigmas, s, right=True) - 1
        return torch.clamp(idx, 0, self.num_sigma - 1)

    # -- score ----------------------------------------------------------
    def score(self, rotvec: torch.Tensor, t, eps: float = 1e-6) -> torch.Tensor:
        """Score of the IGSO(3) density at axis-angle ``rotvec`` (..., 3):
        the score-norm row of ``t`` linearly interpolated over the omega
        grid at the smoothed angle ``sqrt(|v|^2 + eps^2)``. ``t`` is a scalar
        or broadcasts to ``rotvec[..., 0]``."""
        omega = torch.sqrt(torch.sum(rotvec * rotvec, dim=-1) + eps * eps)
        rows = self.score_norm[self.t_to_idx(t)]
        rows = torch.broadcast_to(rows, omega.shape + rows.shape[-1:])
        omegas = self.omegas
        oidx = torch.clamp(torch.searchsorted(omegas, omega) - 1, 0, omegas.shape[0] - 2)
        x0, x1 = omegas[oidx], omegas[oidx + 1]
        y0 = torch.gather(rows, -1, oidx[..., None])[..., 0]
        y1 = torch.gather(rows, -1, (oidx + 1)[..., None])[..., 0]
        w = torch.clamp((omega - x0) / (x1 - x0), 0.0, 1.0)
        norm = y0 + w * (y1 - y0)
        return norm[..., None] * rotvec / (omega[..., None] + eps)

    def score_scaling(self, t):
        return self.score_scaling_table[self.t_to_idx(t)]

    # -- sampling -------------------------------------------------------
    def sample(self, t, shape, generator: Optional[torch.Generator] = None,
               axis: Optional[torch.Tensor] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Axis-angle samples of IGSO(3) at ``t`` by inverse CDF. ``axis``
        (shape + (3,), normal) and ``u`` (shape, uniform) are the draws;
        those not given come from ``generator``."""
        shape = tuple(shape)
        dev = self.device
        if axis is None:
            axis = torch.randn(shape + (3,), generator=generator, device=dev)
        if u is None:
            u = torch.rand(shape, generator=generator, device=dev)
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(1e-12)
        rows = self.cdf[self.t_to_idx(t)]
        rows = torch.broadcast_to(rows, shape + rows.shape[-1:])
        # inverse CDF: index of the first grid point with cdf >= u
        idx = torch.sum((rows < u[..., None]).to(torch.int64), dim=-1)
        idx = torch.clamp(idx, 1, rows.shape[-1] - 1)
        c0 = torch.gather(rows, -1, (idx - 1)[..., None])[..., 0]
        c1 = torch.gather(rows, -1, idx[..., None])[..., 0]
        o0, o1 = self.omegas[idx - 1], self.omegas[idx]
        w = torch.clamp((u - c0) / torch.clamp_min(c1 - c0, 1e-12), 0.0, 1.0)
        angle = o0 + w * (o1 - o0)
        return axis * angle[..., None]

    def sample_ref(self, shape, generator: Optional[torch.Generator] = None,
                   **draws) -> torch.Tensor:
        return self.sample(1.0, shape, generator=generator, **draws)

    # -- reverse step ---------------------------------------------------
    def reverse_perturbation(self, score_t, t, dt, *, stochastic: bool,
                             noise_scale: float = 1.0, z: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None):
        """Tangent update of the geodesic random walk; ``z`` is the unscaled
        normal draw of a stochastic step."""
        g = self.diffusion_coef(t)
        if stochastic:
            if z is None:
                z = torch.randn(score_t.shape, generator=generator, device=score_t.device)
            z = noise_scale * z
            return g**2 * score_t * dt + g * torch.sqrt(torch.as_tensor(dt)) * z
        return (1.0 - 0.5 * noise_scale**2) * g**2 * score_t * dt
