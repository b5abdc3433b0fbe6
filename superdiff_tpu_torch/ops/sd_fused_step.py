"""Fused sigma-space OR-composition step epilogue.

Port of ``superdiff_tpu/ops/pallas/sd_fused_step.py``. After the batched UNet
forward produces the three velocities, one kernel computes the OR kappa from
the running log-likelihoods, the CFG-mixed field, the Euler-Maruyama update
and both conditionings' divergence-free Itô increments in one pass over
device memory (all fp32):

  kappa    = softmax([T (ll_obj + logp), T ll_bg])[0]
  vf       = v_unc + g ((v_bg - v_unc) + kappa (v_obj - v_bg))
  dx       = 2 dsigma vf + sqrt(2 |dsigma| sigma) eps
  dll_i    = -sum(v_i (dx + dsigma v_i)) / sigma          (i = obj, bg)

The Hopper kernel is ``csrc/sd_fused_step.cu``: one launch, each row split
over a thread-block cluster of 8 CTAs; sigma and dsigma are read from device memory,
so a launch captured in a CUDA graph serves every step. ``sd_or_step``
launches it for CUDA tensors and runs :func:`sd_or_step_reference` for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.ito import dlogq_sde_sigma_space_or
from ..core.kappa import kappa_or
from . import _build

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sd_or_step_launch": (_ci, [_vp] * 11 + [_ci] * 2 + [_cf] * 3 + [_vp]),
}


def _f32(s) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32)


def sd_or_step_reference(v_obj, v_bg, v_unc, x, eps, ll, sigma, dsigma,
                         *, temperature=1.0, logp=0.0, guidance=7.5):
    """Plain PyTorch version with the kernel's math (CPU path, test oracle).

    ``sigma``/``dsigma`` are float32 scalars (0-d tensors on any device, or
    floats); the scalar arithmetic runs in float32, as the kernel's does."""
    sigma, dsigma = _f32(sigma), _f32(dsigma)
    kappa = kappa_or(ll[:, 0], ll[:, 1], temperature, logp)
    vf = v_unc + guidance * ((v_bg - v_unc) + kappa[:, None] * (v_obj - v_bg))
    dx = 2.0 * dsigma * vf + torch.sqrt(2.0 * torch.abs(dsigma) * sigma) * eps
    dll = dlogq_sde_sigma_space_or(torch.stack([v_obj, v_bg]), dx, sigma, dsigma)
    return x + dx, ll + dll, kappa


def _launch(v_obj, v_bg, v_unc, x, eps, ll, sigma, dsigma, temperature, logp,
            guidance):
    rows = (v_obj, v_bg, v_unc, x, eps)
    _build.require_cuda("sd_or_step", *rows, ll)
    b, d = x.shape
    for t in rows:
        if t.shape != (b, d) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"sd_or_step: rows must be contiguous fp32 ({b}, {d}), got "
                f"{tuple(t.shape)} {t.dtype}")
    if ll.shape != (b, 2) or ll.dtype != torch.float32 or not ll.is_contiguous():
        raise ValueError(f"sd_or_step: ll must be contiguous fp32 ({b}, 2)")
    sigma, dsigma = _build.device_scalars("sd_or_step", x.device, sigma, dsigma)
    lib = _build.load("sd_fused_step", _SIGNATURES)
    new_x = torch.empty_like(x)
    new_ll = torch.empty_like(ll)
    kappa = torch.empty((b,), dtype=torch.float32, device=x.device)
    p = _build.ptr
    err = lib.sd_or_step_launch(
        p(v_obj), p(v_bg), p(v_unc), p(x), p(eps), p(ll), p(new_x), p(new_ll),
        p(kappa), p(sigma), p(dsigma), b, d, float(temperature), float(logp),
        float(guidance), _build.stream_ptr(x))
    _build.check(err, "sd_or_step")
    sd_or_step.launches += 1
    return new_x, new_ll, kappa


def sd_or_step(v_obj, v_bg, v_unc, x, eps, ll, sigma, dsigma,
               *, temperature=1.0, logp=0.0, guidance=7.5):
    """One OR step on (B, D) fp32 rows: returns (new_x, new_ll (B, 2), kappa (B,)).

    ``sigma``/``dsigma`` are float32 scalars. On the card the kernel reads
    them from device memory: 0-d fp32 CUDA tensors are read where they lie
    (what a captured sampler step passes), floats are first copied to the
    card. CUDA tensors go to the kernel (or raise); CPU tensors take
    :func:`sd_or_step_reference`.
    """
    if x.is_cuda:
        return _launch(v_obj, v_bg, v_unc, x, eps, ll, sigma, dsigma,
                       temperature, logp, guidance)
    return sd_or_step_reference(v_obj, v_bg, v_unc, x, eps, ll, sigma, dsigma,
                                temperature=temperature, logp=logp,
                                guidance=guidance)


sd_or_step.launches = 0

