"""Fused LayerNorm + GEGLU feed-forward + residual.

Port of ``geglu_ffn_block`` from ``superdiff_tpu/ops/pallas/geglu_ffn.py``:

  out = x + (v * gelu_erf(g)) W2^T + b2,   [v | g] = LN(x) W1^T + b1

with the LayerNorm in fp32 (flax's fast variance, clamped at 0) and the
exact erf gelu. Weights use PyTorch's Linear layout: ``w1`` (2F, C) with the
value half first, ``w2`` (C, F); the JAX function takes their transposes.

The Hopper kernel is ``csrc/geglu_ffn.cu`` (three launches: LN writing a
bf16 LN(x), W1 + GEGLU writing a bf16 hidden, then W2 + bias + residual).
``geglu_ffn_block`` launches it for CUDA tensors (bf16 x and weights; C and
F multiples of 64; anything else raises) and runs :func:`_reference_block`
for CPU tensors.
Forward-mode derivatives route through :func:`_reference_block`, as JAX's
``_ffn_jvp`` does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "geglu_col_tile": (_ci, []),
    "geglu_block_launch": (_ci, [_vp] * 10 + [_ci] * 3 + [_cf, _vp]),
}


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


def _launch(x2, gamma, beta, w1, b1, w2, b2, eps):
    _build.require_cuda("geglu_ffn_block", x2, gamma, beta, w1, b1, w2, b2)
    m, c = x2.shape
    f = w2.shape[1]
    if w1.shape != (2 * f, c) or w2.shape != (c, f):
        raise ValueError(
            f"geglu_ffn_block: w1 must be (2F, C), w2 (C, F); got "
            f"{tuple(w1.shape)}, {tuple(w2.shape)} for C={c}")
    for name, t in (("x", x2), ("w1", w1), ("w2", w2)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"geglu_ffn_block: {name} must be contiguous bf16")
    lib = _build.load("geglu_ffn", _SIGNATURES)
    cols = lib.geglu_col_tile()
    if c % cols or f % cols:
        raise ValueError(
            f"geglu_ffn_block: kernel takes C and F multiples of {cols}; "
            f"got C={c}, F={f}")
    vec = lambda v: v.float().contiguous()
    gamma, beta, b1, b2 = vec(gamma), vec(beta), vec(b1), vec(b2)
    xn = torch.empty_like(x2)
    h = torch.empty((m, f), dtype=torch.bfloat16, device=x2.device)
    out = torch.empty_like(x2)
    p = _build.ptr
    err = lib.geglu_block_launch(p(x2), p(gamma), p(beta), p(w1), p(b1), p(w2),
                                 p(b2), p(xn), p(h), p(out), m, c, f, float(eps),
                                 _build.stream_ptr(x2))
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
