"""Long-row softmax attention in the d-major ('eod') layout.

Port of ``flash_mha_eod`` from ``superdiff_tpu/ops/pallas/flash_attention.py``:
q, v and the output live in (B, H, D, L), k in (B, H, L, D). The SD UNet
routes its long self-attention rows (the 4096- and 1024-token layers) here;
the short rows (256- and 64-token self-attention, 77-token cross-attention)
stay plain PyTorch, as the JAX package sends them to its einsum reference.

The Hopper kernel is ``csrc/flash_attention.cu``. ``flash_mha_eod`` launches
it for CUDA tensors (bf16, head dims 40/80, L a multiple of 64; anything
else raises) and runs :func:`_reference_eod` for CPU tensors. Forward-mode
derivatives route through :func:`_reference_eod`, as JAX's ``_flash_eod_jvp``
does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LOG2_E = 1.4426950408889634
_vp, _ci, _cl, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "attn_eod_supports": (_ci, [_ci]),
    "attn_eod_tile": (_ci, []),
    "attn_eod_launch": (_ci, [_vp] * 4 + [_ci] * 4 + [_cl] * 3 + [_cf, _vp]),
}


def _reference_eod(qt, k, vt, sm_scale: float):
    """Plain attention in the d-major layout: qt/vt/out (B, H, D, L),
    k (B, H, L, D); fp32 logits and softmax, probabilities cast to v's dtype."""
    logits = torch.einsum("bhdq,bhkd->bhqk", qt, k).float() * sm_scale
    attn = torch.softmax(logits, dim=-1).to(vt.dtype)
    return torch.einsum("bhqk,bhdk->bhdq", attn, vt)


def _launch(qt, k, vt, sm_scale):
    _build.require_cuda("flash_mha_eod", qt, k, vt)
    b, h, d, l = qt.shape
    if k.shape != (b, h, l, d) or vt.shape != (b, h, d, l):
        raise ValueError(
            f"flash_mha_eod: self-attention shapes qt/vt (B,H,D,L), k (B,H,L,D); "
            f"got {tuple(qt.shape)}, {tuple(k.shape)}, {tuple(vt.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (qt, k, vt)):
        raise ValueError("flash_mha_eod: the kernel takes bf16 q, k, v")
    if not (qt.is_contiguous() and vt.is_contiguous()):
        raise ValueError("flash_mha_eod: qt and vt must be contiguous (B,H,D,L)")
    lib = _build.load("flash_attention", _SIGNATURES)
    tile = lib.attn_eod_tile()
    if not lib.attn_eod_supports(d) or l % tile:
        raise ValueError(
            f"flash_mha_eod: kernel takes head_dim 40 or 80 and L a "
            f"multiple of {tile}; got D={d}, L={l}")
    sb, sh, sl, sd = k.stride()
    if sd != 1 or sb % 8 or sh % 8 or sl % 8 or k.data_ptr() % 16:
        raise ValueError("flash_mha_eod: k rows must be unit-stride along D and "
                         "16-byte aligned")
    out = torch.empty_like(qt)
    p = _build.ptr
    err = lib.attn_eod_launch(p(qt), p(k), p(vt), p(out), b, h, d, l, sb, sh, sl,
                              float(sm_scale * LOG2_E), _build.stream_ptr(qt))
    _build.check(err, "flash_mha_eod")
    flash_mha_eod.launches += 1
    return out


class _FlashEod(torch.autograd.Function):
    """Kernel (CUDA) or reference (CPU) forward; tangents through the
    reference."""

    @staticmethod
    def forward(qt, k, vt, sm_scale):
        if qt.is_cuda:
            return _launch(qt, k, vt, sm_scale)
        return _reference_eod(qt, k, vt, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qt, k, vt, sm_scale = inputs
        ctx.save_for_forward(qt, k, vt)
        ctx.sm_scale = sm_scale

    @staticmethod
    def jvp(ctx, qt_t, k_t, vt_t, _):
        qt, k, vt = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip((qt, k, vt), (qt_t, k_t, vt_t)))
        _, out_t = torch.func.jvp(
            lambda a, b, c: _reference_eod(a, b, c, ctx.sm_scale),
            (qt, k, vt), tangents)
        return out_t


def flash_mha_eod(qt, k, vt, *, sm_scale: float | None = None):
    """softmax(q k^T * sm_scale) v with qt/vt/out (B, H, D, L), k (B, H, L, D)."""
    if sm_scale is None:
        sm_scale = qt.shape[2] ** -0.5
    return _FlashEod.apply(qt, k, vt, float(sm_scale))


flash_mha_eod.launches = 0
