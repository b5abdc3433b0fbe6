"""R^3 VP-SDE diffuser for backbone translations (port of
``superdiff_tpu/models/protein/r3.py``).

Linear beta schedule ``b(t) = min_b + t (max_b - min_b)``, drift
``f(x,t) = -b(t) x / 2``, diffusion ``g(t) = sqrt(b(t))``, coordinate
scaling 0.1. ``t`` is a Python float or a float32 tensor on the data's
device; every method is elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class R3Diffuser:
    min_b: float = 0.1
    max_b: float = 20.0
    coordinate_scaling: float = 0.1

    def scale(self, x):
        return x * self.coordinate_scaling

    def unscale(self, x):
        return x / self.coordinate_scaling

    def b_t(self, t):
        return self.min_b + t * (self.max_b - self.min_b)

    def marginal_b_t(self, t):
        return t * self.min_b + 0.5 * t**2 * (self.max_b - self.min_b)

    def diffusion_coef(self, t):
        return torch.sqrt(torch.as_tensor(self.b_t(t)))

    def drift_coef(self, x, t):
        return -0.5 * self.b_t(t) * x

    def conditional_var(self, t):
        return 1.0 - torch.exp(-torch.as_tensor(self.marginal_b_t(t)))

    def score_scaling(self, t):
        return 1.0 / torch.sqrt(self.conditional_var(t))

    def score(self, x_t, x_0, t, scaled: bool = True):
        """Score of p(x_t | x_0); inputs in scaled coordinates unless noted."""
        if not scaled:
            x_t, x_0 = self.scale(x_t), self.scale(x_0)
        mb = torch.as_tensor(self.marginal_b_t(t))
        return -(x_t - torch.exp(-0.5 * mb) * x_0) / self.conditional_var(t)

    def calc_trans_score(self, trans_t, trans_0, t):
        """Score from a predicted clean translation (angstrom inputs)."""
        return self.score(trans_t, trans_0, t, scaled=False)

    def sample_ref(self, shape, generator: Optional[torch.Generator] = None,
                   device="cuda"):
        return torch.randn(tuple(shape) + (3,), generator=generator, device=device)

    def reverse_perturbation(self, x_t_scaled, score_t, t, dt, *, stochastic: bool,
                             noise_scale: float = 1.0, z: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None):
        """EM (or deterministic-ODE) update in scaled coordinates; the next
        state is ``x - perturb``. ``z`` is the unscaled normal draw of a
        stochastic step (drawn from ``generator`` when not given)."""
        g = self.diffusion_coef(t)
        f = self.drift_coef(x_t_scaled, t)
        if stochastic:
            if z is None:
                z = torch.randn(score_t.shape, generator=generator, device=score_t.device)
            z = noise_scale * z
            return (f - g**2 * score_t) * dt + g * torch.sqrt(torch.as_tensor(dt)) * z
        return (f - g**2 * score_t * (1.0 + 0.5 * noise_scale**2)) * dt
