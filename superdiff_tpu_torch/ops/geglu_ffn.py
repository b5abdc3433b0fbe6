"""Fused LayerNorm + GEGLU feed-forward + residual.

Port of ``geglu_ffn_block`` from ``superdiff_tpu/ops/pallas/geglu_ffn.py``:

  out = x + (v * gelu_erf(g)) W2^T + b2,   [v | g] = LN(x) W1^T + b1

with the LayerNorm in fp32 (flax's fast variance, clamped at 0) and the
exact erf gelu. Weights use PyTorch's Linear layout: ``w1`` (2F, C) with the
value half first, ``w2`` (C, F); the JAX function takes their transposes.

The Hopper kernel is ``csrc/geglu_ffn.cu`` (three launches: LN writing a
bf16 LN(x); W1 with the GEGLU as the epilogue of a persistent ``wgmma`` +
TMA GEMM, writing a bf16 hidden; W2 with bias + residual as its epilogue).
Its gelu is the TPU kernel's FMA-only polynomial, :func:`_gelu_poly` here.
``geglu_ffn_block`` launches it for CUDA tensors (bf16 x and weights; gamma,
beta and the biases bf16 or fp32, read as stored; C and F multiples of 64,
any M; anything else raises) and runs :func:`_reference_block` for CPU
tensors.
Forward-mode derivatives route through :func:`_reference_block`, as JAX's
``_ffn_jvp`` does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "geglu_block_launch": (_ci, [_vp] * 10 + [_ci] * 3 + [_cf, _ci, _vp]),
}
# C and F must be multiples of the kernel's column tile (one TMA box wide)
_COL_TILE = 64

# The TPU kernel's gelu (superdiff_tpu/ops/pallas/geglu_ffn.py::_gelu_kernel):
# Phi(x) - 1/2 = x * p(x^2) on |x| <= 5.5, p a degree-14 Chebyshev fit as a
# power-basis Horner in n = x^2 * 2 / 5.5^2 - 1; within 1.2e-6 of the exact
# erf gelu
_GELU_P_COEF = (
    1.285519294e-01, -6.417257621e-02, 4.773779589e-02, -3.878402957e-02,
    3.206722320e-02, -2.614160622e-02, 2.038480692e-02, -1.456035862e-02,
    1.016421201e-02, -7.878193782e-03, 4.723569624e-03, -1.051773090e-03,
    6.399065034e-04, -1.428040806e-03, 6.562366469e-04)
_GELU_P_SCALE = 2.0 / (5.5 * 5.5)


def _gelu_poly(x):
    """Plain version of the kernel's gelu, in fp32."""
    xc = x.clamp(-5.5, 5.5)
    n = xc * xc * _GELU_P_SCALE - 1.0
    p = torch.full_like(x, _GELU_P_COEF[-1])
    for c in _GELU_P_COEF[-2::-1]:
        p = p * n + c
    return x * (0.5 + xc * p)


def _layernorm(x32, gamma, beta, eps: float):
    """Row LayerNorm in fp32, flax fast-variance convention."""
    mu = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x32 - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _reference_block(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """Plain version of the block with the JAX reference's casts."""
    xn = _layernorm(x.float(), gamma, beta, eps).to(w1.dtype)
    h = xn @ w1.t() + b1.to(w1.dtype)
    v, g = h.chunk(2, dim=-1)
    h = v * torch.nn.functional.gelu(g.float()).to(h.dtype)
    return x + (h @ w2.t() + b2.to(w2.dtype)).to(x.dtype)


def _check_shapes(x_shape, w1_shape, w2_shape):
    """(M, C, F) of the kernel's operands; ValueError unless w1 is (2F, C),
    w2 (C, F), and C and F are positive multiples of 64 (M any size)."""
    m, c = x_shape
    f = w2_shape[1]
    if tuple(w1_shape) != (2 * f, c) or tuple(w2_shape) != (c, f):
        raise ValueError(
            f"geglu_ffn_block: w1 must be (2F, C), w2 (C, F); got "
            f"{tuple(w1_shape)}, {tuple(w2_shape)} for C={c}")
    if c % _COL_TILE or f % _COL_TILE or c == 0 or f == 0:
        raise ValueError(
            f"geglu_ffn_block: the kernel takes C and F positive multiples of "
            f"{_COL_TILE}; got C={c}, F={f}")
    return m, c, f


def _launch(x2, gamma, beta, w1, b1, w2, b2, eps):
    _build.require_cuda("geglu_ffn_block", x2, gamma, beta, w1, b1, w2, b2)
    m, c, f = _check_shapes(x2.shape, w1.shape, w2.shape)
    for name, t in (("x", x2), ("w1", w1), ("w2", w2)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geglu_ffn_block: {name} must be contiguous bf16, 16-byte aligned")
    vec_bf16 = 0
    for bit, (name, t, n) in enumerate((("gamma", gamma, c), ("beta", beta, c),
                                        ("b1", b1, 2 * f), ("b2", b2, c))):
        if (t.dtype not in (torch.bfloat16, torch.float32) or t.shape != (n,)
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"geglu_ffn_block: {name} must be a contiguous ({n},) bf16 or "
                             f"fp32 vector, 16-byte aligned")
        vec_bf16 |= (t.dtype == torch.bfloat16) << bit
    if m == 0:
        return x2.clone()
    lib = _build.load("geglu_ffn", _SIGNATURES)
    xn = torch.empty_like(x2)
    h = torch.empty((m, f), dtype=torch.bfloat16, device=x2.device)
    out = torch.empty_like(x2)
    p = _build.ptr
    err = lib.geglu_block_launch(p(x2), p(gamma), p(beta), p(w1), p(b1), p(w2),
                                 p(b2), p(xn), p(h), p(out), m, c, f, float(eps),
                                 vec_bf16, _build.stream_ptr(x2))
    _build.check(err, "geglu_ffn_block")
    geglu_ffn_block.launches += 1
    return out


class _GegluBlock(torch.autograd.Function):
    """Kernel (CUDA) or reference (CPU) forward; tangents through the
    reference."""

    @staticmethod
    def forward(x2, gamma, beta, w1, b1, w2, b2, eps):
        if x2.is_cuda:
            return _launch(x2, gamma, beta, w1, b1, w2, b2, eps)
        return _reference_block(x2, gamma, beta, w1, b1, w2, b2, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:7])
        ctx.eps = inputs[7]

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents[:7]))
        _, out_t = torch.func.jvp(
            lambda *a: _reference_block(*a, eps=ctx.eps), primals, tangents)
        return out_t


def geglu_ffn_block(x, gamma, beta, w1, b1, w2, b2, *, eps: float = 1e-5):
    """Transformer FFN sub-block ``x + FFN(LayerNorm(x))`` on x (..., C)."""
    lead, c = x.shape[:-1], x.shape[-1]
    out = _GegluBlock.apply(x.reshape(-1, c), gamma, beta, w1, b1, w2, b2,
                            float(eps))
    return out.reshape(*lead, c)


geglu_ffn_block.launches = 0
