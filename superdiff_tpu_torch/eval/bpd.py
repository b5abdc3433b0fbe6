"""Bits per dimension through the probability-flow ODE (port of
``superdiff_tpu/eval/bpd.py``; parity with ``cifar/eval_utils.py:14-45``).

``(x, delta_logp)`` is integrated forward in time, the divergence a
Hutchinson estimate from one ``torch.func.jvp`` with a Rademacher probe
(``vf_jac``, ``eval_utils.py:24-28``), then the Gaussian endpoint
log-density and the uniform-dequantization offset (+7 bits for [0, 256)
scaling, ``eval_utils.py:42``). Two integrators, as in JAX: a fixed-step
RK4 and the adaptive Dormand-Prince 5(4) of the reference's diffrax
``Dopri5``. JAX runs them as one ``lax.scan`` / ``lax.while_loop``; here
they are Python loops over tensors, the adaptive one reading its error
norm on the host at each step. Time and the step-control scalars are
float32, as in JAX.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import ito

State = Sequence[torch.Tensor]


def odeint_rk4(f: Callable, y0: State, t0: float, t1: float, n_steps: int) -> tuple:
    """Fixed-step RK4 over a tuple of tensors; ``f(t, y) -> dy/dt`` with
    ``t`` a 0-d float32 tensor on the first leaf's device."""
    dt = (t1 - t0) / n_steps
    t = torch.tensor(t0, dtype=torch.float32, device=y0[0].device)
    y = tuple(y0)
    for _ in range(n_steps):
        k1 = f(t, y)
        k2 = f(t + dt / 2, tuple(a + dt / 2 * b for a, b in zip(y, k1)))
        k3 = f(t + dt / 2, tuple(a + dt / 2 * b for a, b in zip(y, k2)))
        k4 = f(t + dt, tuple(a + dt * b for a, b in zip(y, k3)))
        y = tuple(a + dt / 6 * (b1 + 2 * b2 + 2 * b3 + b4)
                  for a, b1, b2, b3, b4 in zip(y, k1, k2, k3, k4))
        t = t + dt
    return y


# Dormand-Prince 5(4) tableau (the diffrax Dopri5 the reference integrates
# with, ``cifar/eval_utils.py:30-37``).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _fma32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """``a * b + c`` rounded once to float32, as XLA's fused multiply-add
    computes the jitted ``t + c_i * dt`` (the float64 product of two
    float32 values is exact)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _fma(a, b, c, dtype: torch.dtype) -> torch.Tensor:
    """``a * b + c`` over tensors (or float32 scalars) rounded once to
    ``dtype``: XLA's CPU code contracts a product into the add that takes
    it, so each such pair of the jitted integrator rounds once."""
    def wide(v):
        return v.double() if torch.is_tensor(v) else float(v)

    return (wide(a) * wide(b) + wide(c)).to(dtype)


def _combo(ks: Sequence[torch.Tensor], coefs: Sequence[float], dtype: torch.dtype) -> torch.Tensor:
    """``sum_j c_j k_j`` (``len(ks) >= 2``) as XLA's jitted loop rounds it:
    ``fma(k_0, c_0, k_1 c_1)``, then ``fma(k_j, c_j, acc)`` in order, the
    float32 coefficients zeros included."""
    c = [np.float32(x) for x in coefs]
    acc = _fma(ks[0], c[0], ks[1] * float(c[1]), dtype)
    for k, cj in zip(ks[2:], c[2:]):
        acc = _fma(k, cj, acc, dtype)
    return acc


def _stage(y: State, dt: np.float32, ks: Sequence[State], coefs: Sequence[float]) -> tuple:
    """``y + dt * sum(c_j k_j)`` leaf by leaf, rounded as XLA's jitted loop
    rounds it: one term folds ``dt * c`` into a float32 scalar first
    (``fma(k, dt c, y)``), more terms round ``fma(dt, combo, y)``."""
    out = []
    for i, a in enumerate(y):
        kk = [k[i] for k in ks]
        if len(kk) == 1:
            out.append(_fma(kk[0], np.float32(dt * np.float32(coefs[0])), a, a.dtype))
        else:
            out.append(_fma(dt, _combo(kk, coefs, a.dtype), a, a.dtype))
    return tuple(out)


_libm = ctypes.CDLL(None)
_libm.powf.restype = ctypes.c_float
_libm.powf.argtypes = (ctypes.c_float, ctypes.c_float)


def _powf(x: np.float32, y: np.float32) -> np.float32:
    """The C library's ``powf``, which XLA's CPU ``power`` calls (numpy's
    float32 power rounds differently in about a quarter of the cases)."""
    return np.float32(_libm.powf(float(x), float(y)))


def odeint_dopri5(
    f: Callable,
    y0: State,
    t0: float,
    t1: float,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 4096,
):
    """Adaptive Dormand-Prince 5(4) over a tuple of tensors, the JAX
    module's step rule: FSAL (an accepted step's 7th stage seeds the next
    step's first, so it costs 6 fresh evaluations), the I controller ``dt *
    clip(0.9 err^(-1/5), 0.2, 5)`` with a scalar RMS error norm over the
    whole state (diffrax's default norm), ``dt`` cut to land on ``t1``, at
    most ``max_steps`` attempts. The state stays in ``y0``'s dtype; t, dt
    and the controller are float32 scalars on the host. Each product that
    XLA's CPU code contracts into an add (stage times, stage sums, the 5th
    order solution, the error estimate, the norm's scale) rounds once, and
    ``err^(-1/5)`` is the C library's ``powf``, so over a shared vector
    field the two controllers take the same steps; the norm's sum keeps
    torch's order.

    Returns ``(y, nfe)``: nfe counts every ``f`` evaluation, rejected
    steps included, as the reference reports it.
    """
    f32 = np.float32
    t0, t1 = f32(t0), f32(t1)
    dev = y0[0].device

    def step(t, y, k1, dt):
        ks = [k1]
        for i in range(1, 7):
            tt = torch.tensor(_fma32(f32(_DP_C[i]), dt, t), dtype=torch.float32, device=dev)
            ks.append(f(tt, _stage(y, dt, ks, _DP_A[i])))
        y5 = _stage(y, dt, ks, _DP_B5)
        e_coefs = [b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4)]
        err = tuple(_combo([k[i] for k in ks], e_coefs, a.dtype) * float(dt)
                    for i, a in enumerate(y))
        return y5, err, ks[-1]  # FSAL: k7 == f(t + dt, y5)

    def err_norm(err, y_old, y_new) -> np.float32:
        # XLA's rounding: scale = fma(max, rtol, atol); the leaf sums added
        # in leaf order; the mean a product with float32(1 / count).
        sq_sum, count = None, 0
        for e, a, b in zip(err, y_old, y_new):
            scale = _fma(torch.maximum(a.abs(), b.abs()), f32(rtol), f32(atol), e.dtype)
            r = (e / scale).float()
            s = torch.sum(r * r)
            sq_sum = s if sq_sum is None else sq_sum + s
            count += r.numel()
        return f32(np.sqrt(f32(f32(sq_sum.item()) * f32(1.0 / count))))

    y = tuple(y0)
    k1 = f(torch.tensor(t0, dtype=torch.float32, device=dev), y)
    t, dt = t0, (t1 - t0) / f32(100.0)
    nfe, n = 1, 0
    while t < t1 and n < max_steps:
        dt = min(dt, t1 - t)
        y_new, err, k_last = step(t, y, k1, dt)
        e = err_norm(err, y, y_new)
        factor = np.clip(f32(0.9) * _powf(max(e, f32(1e-10)), f32(-0.2)), f32(0.2), f32(5.0))
        if e <= 1.0:
            t, y, k1 = f32(t + dt), y_new, k_last
        dt = f32(dt * factor)
        nfe, n = nfe + 6, n + 1
    return y, nfe


def make_bpd_estimator(
    score_apply: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule,
    *,
    method: str = "rk4",
    n_steps: int = 100,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    t_0: float = 1e-5,
    t_1: float = 1.0,
):
    """BPD of data under one model's probability-flow ODE.

    ``score_apply(t, x) -> sigma-scaled score`` (``t`` a 0-d float32
    tensor; the eval parameters closed over). Returns ``bpd(x_0, *,
    generator=None, probe=None) -> (bpd scalar tensor, nfe)``: the
    Rademacher probe (x_0's shape) is drawn from ``generator`` on x_0's
    device unless given (the tests hand in JAX's draw).

    ``method='dopri5'`` integrates with the adaptive Dormand-Prince 5(4)
    (``rtol`` / ``atol`` apply, ``n_steps`` is ignored); ``'rk4'`` (the
    default) with the fixed grid of ``n_steps`` steps, which the JAX
    package's adequacy sweep found within 1e-3 bits/dim of dopri5 at 1e-5
    for the default 100 steps.
    """
    if method not in ("rk4", "dopri5"):
        raise ValueError(f"unknown BPD integrator {method!r}")

    def bpd(x_0: torch.Tensor, *, generator: Optional[torch.Generator] = None,
            probe: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
        if probe is None:
            probe = ito.rademacher(x_0.shape, generator, x_0.dtype, x_0.device)
        probe = torch.as_tensor(probe, dtype=x_0.dtype, device=x_0.device)
        dims = tuple(range(1, x_0.ndim))
        d = math.prod(x_0.shape[1:])

        def vf(t, state):
            x, _ = state

            def dxdt(_x):
                return schedule.dlog_alpha_dt(t) * _x - schedule.beta(t) * score_apply(t, _x)

            dx, tangent = torch.func.jvp(dxdt, (x,), (probe,))
            return dx, torch.sum((tangent * probe).float(), dim=dims)

        y0 = (x_0, torch.zeros(x_0.shape[0], dtype=torch.float32, device=x_0.device))
        with torch.no_grad():
            if method == "dopri5":
                (x_1, delta_logp), nfe = odeint_dopri5(vf, y0, t_0, t_1, rtol=rtol, atol=atol)
            else:
                x_1, delta_logp = odeint_rk4(vf, y0, t_0, t_1, n_steps)
                nfe = n_steps * 4
        logp_1 = -0.5 * torch.sum(x_1.float() ** 2, dim=dims) - 0.5 * d * math.log(2 * math.pi)
        logp_0 = logp_1 + delta_logp
        bpd_val = -logp_0 / math.log(2.0) / d + 7.0
        return bpd_val.mean(), nfe

    return bpd
