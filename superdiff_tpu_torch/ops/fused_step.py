"""Fused N-model VP-SDE OR step epilogue of the CIFAR joint sampler.

Port of ``superdiff_tpu/ops/pallas/fused_step.py``. After the N score-network
forwards, one kernel computes the OR weights from the running log-densities,
the Euler-Maruyama step, every model's divergence-free Itô increment and the
max-renormalisation in one pass over device memory (all fp32):

  w        = softmax(T * logq)                     (B, N)
  balanced = sum_n w_n * s_n
  dx       = -dt (da x - 2 beta balanced) + sqrt(2 sigma beta dt) eps
  dlogq_n  = sum_D (f_next - v_n)(dt v_n + 2 dx + dt f_next) / (4 sigma beta)
             with v_n = da x - 2 beta s_n, f_next = da (x + dx)
  new_logq = renormalize(logq + dlogq)

The Hopper kernel is ``csrc/fused_step.cu`` (one launch, each batch row
split over a thread-block cluster; see its header for the byte bound and
the design); da, beta, sigma and dt are read from device memory, so a
launch captured in a CUDA graph serves every step. ``fused_sde_step``
launches it for CUDA tensors and runs :func:`fused_sde_step_reference` for
CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_sde_step_max_models": (_ci, []),
    "fused_sde_step_launch": (_ci, [_vp] * 6 + [_ci] * 3 + [_vp] * 4 + [_cf, _vp]),
}


def _f32(s) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32)


def fused_sde_step_reference(sscores, x, eps, logq, da, beta, sigma, dt, *,
                             temperature=1e6):
    """Plain PyTorch version in the JAX reference's order of operations
    (CPU path, test oracle). sscores (N, B, D), x and eps (B, D), logq (B, N),
    all fp32; the scalars are float32 values (0-d tensors on any device, or
    floats), so the scalar arithmetic runs in float32."""
    da, beta, sigma, dt = map(_f32, (da, beta, sigma, dt))
    w = torch.softmax(temperature * logq, dim=-1)
    balanced = torch.einsum("bn,nbd->bd", w, sscores)
    dx = -dt * (da * x - 2.0 * beta * balanced) + torch.sqrt(2.0 * sigma * beta * dt) * eps
    v = da * x[None] - 2.0 * beta * sscores
    f_next = da * (x + dx)[None]
    num = (f_next - v) * (dt * v + 2.0 * dx[None] + dt * f_next)
    dlogq = num.sum(-1).T / (4.0 * sigma * beta)
    new_logq = logq + dlogq
    new_logq = new_logq - new_logq.max(dim=-1, keepdim=True).values
    return x + dx, new_logq


def _launch(sscores, x, eps, logq, da, beta, sigma, dt, temperature):
    _build.require_cuda("fused_sde_step", sscores, x, eps, logq)
    n, b, d = sscores.shape
    for name, t, shape in (("sscores", sscores, (n, b, d)), ("x", x, (b, d)),
                           ("eps", eps, (b, d)), ("logq", logq, (b, n))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_sde_step: {name} must be contiguous fp32 {shape}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    lib = _build.load("fused_step", _SIGNATURES)
    if not 1 <= n <= lib.fused_sde_step_max_models():
        raise ValueError(f"fused_sde_step: {n} models; the kernel takes 1 to "
                         f"{lib.fused_sde_step_max_models()}")
    sigma, beta, da, dt = _build.device_scalars("fused_sde_step", x.device, sigma, beta,
                                                da, dt)
    new_x = torch.empty_like(x)
    new_logq = torch.empty_like(logq)
    p = _build.ptr
    err = lib.fused_sde_step_launch(
        p(sscores), p(x), p(eps), p(logq), p(new_x), p(new_logq), n, b, d,
        p(sigma), p(beta), p(da), p(dt), float(temperature), _build.stream_ptr(x))
    _build.check(err, "fused_sde_step")
    fused_sde_step.launches += 1
    return new_x, new_logq


def fused_sde_step(sscores, x, eps, logq, da, beta, sigma, dt, *, temperature=1e6):
    """One joint SDE/OR step: returns (x + dx, renormalised logq (B, N)).

    sscores (N, B, *event), x and eps (B, *event); the latents are flattened
    to (B, D) and the new x comes back in x's shape. The scalars are float32:
    on the card the kernel reads them from device memory, 0-d fp32 CUDA
    tensors where they lie (what a captured sampler step passes), floats
    after a copy to the card. CUDA tensors go to the kernel (or raise); CPU
    tensors take :func:`fused_sde_step_reference`.
    """
    b = x.shape[0]
    s2 = sscores.reshape(sscores.shape[0], b, -1)
    x2, e2 = x.reshape(b, -1), eps.reshape(b, -1)
    if x.is_cuda:
        new_x, new_logq = _launch(s2.contiguous(), x2.contiguous(), e2.contiguous(),
                                  logq.contiguous(), da, beta, sigma, dt, temperature)
    else:
        new_x, new_logq = fused_sde_step_reference(s2, x2, e2, logq, da, beta, sigma, dt,
                                                   temperature=temperature)
    return new_x.reshape(x.shape), new_logq


fused_sde_step.launches = 0

