"""Fused LayerNorm + GEGLU feed-forward + residual, and the unfused FFN.

Port of ``geglu_ffn_block`` and ``geglu_ffn`` from
``superdiff_tpu/ops/pallas/geglu_ffn.py``:

  geglu_ffn_block: out = x + (v * gelu(g)) W2^T + b2,  [v | g] = LN(x) W1^T + b1
  geglu_ffn:       out = (v * gelu(g)) W2^T + b2,      [v | g] = x W1^T + b1

with the LayerNorm in fp32 (flax's fast variance, clamped at 0). The gelu
is tanh's (``approximate=True``, JAX's default) or the exact erf's.
Weights use PyTorch's Linear layout: ``w1`` (2F, C) with the value half
first, ``w2`` (C, F); the JAX functions take their transposes.

The Hopper kernel is ``csrc/geglu_ffn.cu`` (three launches: LN writing a
bf16 LN(x); W1 with the GEGLU as the epilogue of a persistent ``wgmma`` +
TMA GEMM, writing a bf16 hidden; W2 with bias + residual as its epilogue).
Its erf gelu is the TPU kernel's FMA-only polynomial, :func:`_gelu_poly`
here; its tanh gelu is JAX's formula with ``tanhf``. ``geglu_ffn`` skips the
LN launch and the residual. Both entries launch it for CUDA tensors (bf16 x
and weights; gamma, beta and the biases bf16 or fp32, read as stored; C and
F multiples of 64, any M; anything else raises) and run the plain versions
:func:`_reference_block` / :func:`_reference` for CPU tensors (whose erf
flavour is the exact erf gelu). Forward-mode derivatives route through the
plain versions, as JAX's ``_ffn_jvp`` does. Launches are counted per
configuration: ``geglu_ffn_block.launches`` and ``geglu_ffn.launches`` are
dicts keyed by the gelu flavour (``"erf"``, ``"tanh"``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "geglu_block_launch": (_ci, [_vp] * 10 + [_ci] * 3 + [_cf, _ci, _ci, _vp]),
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


def _gelu(x, approximate: bool):
    """gelu in fp32: JAX's tanh form (``jax.nn.gelu(approximate=True)``) or
    the exact erf."""
    if approximate:
        return x * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * (x * x * x)))))
    return torch.nn.functional.gelu(x)


def _layernorm(x32, gamma, beta, eps: float):
    """Row LayerNorm in fp32, flax fast-variance convention."""
    mu = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x32 - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _reference(x, w1, b1, w2, b2, approximate: bool = True):
    """Plain version of ``geglu_ffn`` with the JAX reference's casts."""
    h = x.to(w1.dtype) @ w1.t() + b1.to(w1.dtype)
    v, g = h.chunk(2, dim=-1)
    h = v * _gelu(g.float(), approximate).to(h.dtype)
    return h @ w2.t() + b2.to(w2.dtype)


def _reference_block(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                     approximate: bool = True):
    """Plain version of the block with the JAX reference's casts."""
    xn = _layernorm(x.float(), gamma, beta, eps).to(w1.dtype)
    return x + _reference(xn, w1, b1, w2, b2, approximate).to(x.dtype)


def _check_shapes(x_shape, w1_shape, w2_shape, name="geglu_ffn_block"):
    """(M, C, F) of the kernel's operands; ValueError unless w1 is (2F, C),
    w2 (C, F), and C and F are positive multiples of 64 (M any size)."""
    m, c = x_shape
    f = w2_shape[1]
    if tuple(w1_shape) != (2 * f, c) or tuple(w2_shape) != (c, f):
        raise ValueError(
            f"{name}: w1 must be (2F, C), w2 (C, F); got "
            f"{tuple(w1_shape)}, {tuple(w2_shape)} for C={c}")
    if c % _COL_TILE or f % _COL_TILE or c == 0 or f == 0:
        raise ValueError(
            f"{name}: the kernel takes C and F positive multiples of "
            f"{_COL_TILE}; got C={c}, F={f}")
    return m, c, f


def _launch(x2, gamma, beta, w1, b1, w2, b2, eps, approximate, fused):
    """One kernel call; ``fused`` (LN + residual) for geglu_ffn_block, else
    geglu_ffn (gamma and beta None)."""
    name = "geglu_ffn_block" if fused else "geglu_ffn"
    _build.require_cuda(name, *(a for a in (x2, gamma, beta, w1, b1, w2, b2) if a is not None))
    m, c, f = _check_shapes(x2.shape, w1.shape, w2.shape, name)
    for arg, t in (("x", x2), ("w1", w1), ("w2", w2)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous bf16, 16-byte aligned")
    vec_bf16 = 0
    for bit, (arg, t, n) in enumerate((("gamma", gamma, c), ("beta", beta, c),
                                       ("b1", b1, 2 * f), ("b2", b2, c))):
        if t is None and not fused:
            continue
        if (t.dtype not in (torch.bfloat16, torch.float32) or t.shape != (n,)
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {arg} must be a contiguous ({n},) bf16 or "
                             f"fp32 vector, 16-byte aligned")
        vec_bf16 |= (t.dtype == torch.bfloat16) << bit
    if m == 0:
        return x2.clone() if fused else torch.empty_like(x2)
    lib = _build.load("geglu_ffn", _SIGNATURES)
    xn = torch.empty_like(x2) if fused else None
    h = torch.empty((m, f), dtype=torch.bfloat16, device=x2.device)
    out = torch.empty_like(x2)
    p = _build.ptr
    err = lib.geglu_block_launch(
        p(x2), p(gamma) if fused else None, p(beta) if fused else None, p(w1), p(b1), p(w2),
        p(b2), p(xn) if fused else None, p(h), p(out), m, c, f, float(eps), vec_bf16,
        int(approximate) | (int(fused) << 1), _build.stream_ptr(x2))
    _build.check(err, name)
    (geglu_ffn_block if fused else geglu_ffn).launches["tanh" if approximate else "erf"] += 1
    return out


def _plain_jvp(plain, primals, tangents):
    """The tangent of ``plain`` at ``primals`` (a None tangent is zero)."""
    tangents = tuple(torch.zeros_like(p) if t is None else t for p, t in zip(primals, tangents))
    return torch.func.jvp(plain, primals, tangents)[1]


class _GegluBlock(torch.autograd.Function):
    """Kernel (CUDA) or reference (CPU) forward; tangents through the
    reference."""

    @staticmethod
    def forward(x2, gamma, beta, w1, b1, w2, b2, eps, approximate):
        if x2.is_cuda:
            return _launch(x2, gamma, beta, w1, b1, w2, b2, eps, approximate, True)
        return _reference_block(x2, gamma, beta, w1, b1, w2, b2, eps, approximate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:7])
        ctx.eps, ctx.approximate = inputs[7], inputs[8]

    @staticmethod
    def jvp(ctx, *tangents):
        return _plain_jvp(
            lambda *a: _reference_block(*a, eps=ctx.eps, approximate=ctx.approximate),
            ctx.saved_tensors, tangents)


class _Geglu(torch.autograd.Function):
    """``geglu_ffn``: kernel (CUDA) or reference (CPU) forward; tangents
    through the reference."""

    @staticmethod
    def forward(x2, w1, b1, w2, b2, approximate):
        if x2.is_cuda:
            return _launch(x2, None, None, w1, b1, w2, b2, 1e-5, approximate, False)
        return _reference(x2, w1, b1, w2, b2, approximate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:5])
        ctx.approximate = inputs[5]

    @staticmethod
    def jvp(ctx, *tangents):
        return _plain_jvp(lambda *a: _reference(*a, approximate=ctx.approximate),
                          ctx.saved_tensors, tangents)


def geglu_ffn_block(x, gamma, beta, w1, b1, w2, b2, *, eps: float = 1e-5,
                    approximate: bool = True):
    """Transformer FFN sub-block ``x + FFN(LayerNorm(x))`` on x (..., C);
    ``approximate`` picks the tanh gelu (JAX's default) or the erf one."""
    lead, c = x.shape[:-1], x.shape[-1]
    out = _GegluBlock.apply(x.reshape(-1, c), gamma, beta, w1, b1, w2, b2,
                            float(eps), bool(approximate))
    return out.reshape(*lead, c)


def geglu_ffn(x, w1, b1, w2, b2, *, approximate: bool = True):
    """``(v * gelu(g)) W2^T + b2`` with ``[v | g] = x W1^T + b1`` on x
    (..., C): no LayerNorm, no residual. w1 (2F, C), b1 (2F,), w2 (C, F),
    b2 (C,); ``approximate`` as in :func:`geglu_ffn_block`."""
    lead, c = x.shape[:-1], x.shape[-1]
    out = _Geglu.apply(x.reshape(-1, c), w1, b1, w2, b2, bool(approximate))
    return out.reshape(*lead, c)


# launches by gelu flavour, one count per configuration of the kernel
geglu_ffn_block.launches = {"erf": 0, "tanh": 0}
geglu_ffn.launches = {"erf": 0, "tanh": 0}
