"""Itô density estimators in sigma space (port of the SD forms in
``superdiff_tpu/core/ito.py``).

Along the reverse trajectory ``x + dx`` each conditioning i defines a
marginal density ``q_i``; these divergence-free estimators give the running
change ``dlog q_i`` from the velocities and the realized step alone. All
reductions run in float32 whatever the model's compute dtype.
"""

from __future__ import annotations

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
