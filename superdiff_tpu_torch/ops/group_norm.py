"""GroupNorm with fp32 statistics, an optional per-channel input shift and
an optional SiLU: the computation of ``models.unet.GroupNorm32``.

  group_norm(x, weight, bias, groups, eps, shift=None, silu=False)
      = act((x + shift[:, :, None, None]) * a + b)

with ``a = rsqrt(var + eps) * weight`` and ``b = bias - mean * a`` per
(batch, channel), where each group's mean and fast variance
``max(E[xs^2] - E[xs]^2, 0)`` are taken in fp32 over the fp32 value of
``xs = x + shift`` (the shift is never rounded). The apply is done in fp32
and rounded once to x's dtype; ``act`` is SiLU or the identity. ``shift`` is
an optional (B, C) tensor: a resnet block's time embedding, whose sum with x
only the norm reads.

The Hopper kernel is ``csrc/group_norm.cu`` (two launches, the statistics
then the apply; see its header for the byte bound and the design). It takes
4-D x in bf16 or fp32, laid out ``channels_last`` or NCHW-contiguous and
16-byte aligned, read as it lies; C divisible by ``groups`` and by 8, at
most 4096; weight
and bias (C,) fp32 and shift (B, C) in x's dtype, each with unit stride.
Anything else raises, on any device. :func:`group_norm`
(what ``GroupNorm32`` calls on every device) launches it for CUDA tensors
through one ``torch.autograd.Function``, which runs
:func:`group_norm_plain`'s statistics and apply for CPU tensors; its
backward is the plain GroupNorm backward from the saved fp32 (B, G) mean
and rstd, its forward-mode derivative that of :func:`group_norm_plain`, and
under ``torch.func.vmap`` it launches once per slice of the mapped
dimension. Launches are counted per configuration: ``group_norm.launches``
is a dict keyed ``"silu"`` / ``"plain"``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .geglu_ffn import _plain_jvp

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "group_norm_max_splits": (_ci, []),
    "group_norm_launch": (_ci, [_vp] * 7 + [_ci] * 7 + [_cf, _vp]),
}
# the most channels the kernel takes (one thread a 16-byte vector of a
# channels_last row); checked here so that the CPU path refuses them too
_MAX_CHANNELS = 4096
# flags of group_norm_launch
_F32, _SILU, _SHIFT = 1, 2, 4
_DTYPES = (torch.bfloat16, torch.float32)


def _shifted(x: torch.Tensor, shift: Optional[torch.Tensor]) -> torch.Tensor:
    """``x + shift`` in fp32, the shift broadcast over the spatial axes."""
    x32 = x.float()
    if shift is None:
        return x32
    return x32 + shift.float().reshape(shift.shape + (1,) * (x.ndim - 2))


def _plain_stats(xs: torch.Tensor, groups: int, eps: float):
    """Each group's fp32 mean and rsqrt(fast variance + eps), (B, G)."""
    xg = xs.reshape(xs.shape[0], groups, -1)
    mean = xg.mean(-1)
    var = torch.clamp(xg.square().mean(-1) - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def _plain_apply(x, xs, weight, bias, mean, rstd, silu: bool):
    """``act(xs * a + b)`` in fp32, rounded once to x's dtype."""
    b, c = x.shape[:2]
    per_ch = c // mean.shape[1]
    a = rstd.repeat_interleave(per_ch, dim=1) * weight.float()
    bb = bias.float() - mean.repeat_interleave(per_ch, dim=1) * a
    shape = (b, c) + (1,) * (x.ndim - 2)
    y = xs * a.reshape(shape) + bb.reshape(shape)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_plain(x, weight, bias, groups: int, eps: float,
                     shift: Optional[torch.Tensor] = None, silu: bool = False):
    """Plain PyTorch version (CPU path, test oracle) on x (B, C, *spatial) of
    any layout and dtype: the statistics and the apply as
    :func:`group_norm` defines them."""
    xs = _shifted(x, shift)
    mean, rstd = _plain_stats(xs, groups, eps)
    return _plain_apply(x, xs, weight, bias, mean, rstd, silu)


def _layout(x: torch.Tensor) -> Optional[bool]:
    """True for channels_last, False for NCHW-contiguous, None for neither."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if x.is_contiguous():
        return False
    return None


def _check(x, weight, bias, shift, groups: int) -> bool:
    """Raise ValueError unless the kernel takes these operands; returns
    whether x is channels_last."""
    name = "group_norm"
    if x.ndim != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be 4-D bf16 or fp32, got {tuple(x.shape)} {x.dtype}")
    b, c = x.shape[:2]
    if groups < 1 or c % groups or c % 8 or c > _MAX_CHANNELS:
        raise ValueError(f"{name}: the kernel takes C divisible by the groups and by 8, at "
                         f"most {_MAX_CHANNELS}; got C={c}, groups={groups}")
    channels_last = _layout(x)
    if channels_last is None or (x.is_cuda and x.data_ptr() % 16):
        raise ValueError(f"{name}: x must be channels_last or NCHW-contiguous, 16-byte "
                         f"aligned; got strides {x.stride()}")
    for arg, t, shape, dtype in (("weight", weight, (c,), torch.float32),
                                 ("bias", bias, (c,), torch.float32),
                                 ("shift", shift, (b, c), x.dtype)):
        if t is None:
            continue
        if (tuple(t.shape) != shape or t.dtype != dtype or t.stride(-1) != 1
                or t.device != x.device):
            raise ValueError(f"{name}: {arg} must be {shape} {dtype} with unit stride on "
                             f"{x.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    return channels_last


@functools.cache
def _library():
    """The loaded library and the most partial sums it takes per (batch,
    group), which size the scratch."""
    lib = _build.load("group_norm", _SIGNATURES)
    return lib, lib.group_norm_max_splits()


def _launch(x, weight, bias, shift, groups, eps, silu, channels_last):
    """One kernel call: (y, mean (B, G), rstd (B, G))."""
    _build.require_cuda("group_norm", *(t for t in (x, weight, bias, shift) if t is not None))
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    stats = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        stats.zero_()
        return y, stats[..., 0], stats[..., 1]
    lib, max_splits = _library()
    part = torch.empty((b * groups * max_splits, 2), dtype=torch.float32, device=x.device)
    flags = ((_F32 if x.dtype == torch.float32 else 0) | (_SILU if silu else 0)
             | (_SHIFT if shift is not None else 0))
    p = _build.ptr
    err = lib.group_norm_launch(
        p(x), p(y), p(weight), p(bias), None if shift is None else p(shift), p(part), p(stats),
        b, c, h * w, groups, int(channels_last), flags,
        0 if shift is None else shift.stride(0), float(eps), _build.stream_ptr(x))
    _build.check(err, "group_norm")
    group_norm.launches["silu" if silu else "plain"] += 1
    return y, stats[..., 0], stats[..., 1]


def _backward(gy, x, weight, bias, shift, mean, rstd, silu, needs):
    """The plain GroupNorm backward, in fp32, from the saved statistics:
    (dx, dweight, dbias, dshift), None where ``needs`` says no."""
    b, c = x.shape[:2]
    groups = mean.shape[1]
    per_ch = c // groups
    n = per_ch * math.prod(x.shape[2:])
    spatial = tuple(range(2, x.ndim))
    col = lambda v: v.reshape(v.shape + (1,) * (x.ndim - 2))
    per_channel = lambda v: col(v.repeat_interleave(per_ch, dim=1))
    xhat = (_shifted(x, shift) - per_channel(mean)) * per_channel(rstd)
    w = weight.float().reshape((1, c) + (1,) * (x.ndim - 2))
    dy = gy.float()
    if silu:
        y = xhat * w + bias.float().reshape(w.shape)
        sg = torch.sigmoid(y)
        dy = dy * (sg * (1.0 + y * (1.0 - sg)))
    dweight = (dy * xhat).sum((0,) + spatial).to(weight.dtype) if needs[1] else None
    dbias = dy.sum((0,) + spatial).to(bias.dtype) if needs[2] else None
    dx = dshift = None
    if needs[0] or needs[3]:
        dxhat = dy * w
        group_mean = lambda v: v.sum(spatial).reshape(b, groups, per_ch).sum(-1) / n
        m1, m2 = group_mean(dxhat), group_mean(dxhat * xhat)
        dxs = per_channel(rstd) * (dxhat - per_channel(m1) - xhat * per_channel(m2))
        dx = dxs.to(x.dtype) if needs[0] else None
        dshift = dxs.sum(spatial).to(shift.dtype) if needs[3] else None
    return dx, dweight, dbias, dshift


class _GroupNorm(torch.autograd.Function):
    """Kernel (CUDA) or plain (CPU) forward, returning (y, mean, rstd);
    backward from the saved statistics; tangents through the plain
    version; a vmap rule of one call per slice."""

    @staticmethod
    def forward(x, weight, bias, shift, groups, eps, silu):
        channels_last = _check(x, weight, bias, shift, groups)
        if x.is_cuda:
            return _launch(x, weight, bias, shift, groups, eps, silu, channels_last)
        xs = _shifted(x, shift)
        mean, rstd = _plain_stats(xs, groups, eps)
        return _plain_apply(x, xs, weight, bias, mean, rstd, silu), mean, rstd

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, bias, shift, groups, eps, silu = inputs
        _, mean, rstd = output
        ctx.mark_non_differentiable(mean, rstd)
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        ctx.save_for_backward(x, weight, bias, shift, mean, rstd)
        ctx.save_for_forward(x, weight, bias, shift)

    @staticmethod
    def backward(ctx, gy, _gmean, _grstd):
        x, weight, bias, shift, mean, rstd = ctx.saved_tensors
        grads = _backward(gy, x, weight, bias, shift, mean, rstd, ctx.silu,
                          ctx.needs_input_grad[:4])
        return grads + (None, None, None)

    @staticmethod
    def jvp(ctx, tx, tweight, tbias, tshift, *_):
        x, weight, bias, shift = ctx.saved_tensors[:4]
        has = shift is not None  # a None shift takes no tangent
        plain = lambda x_, w_, b_, *s: group_norm_plain(x_, w_, b_, ctx.groups, ctx.eps,
                                                       s[0] if has else None, ctx.silu)
        t = _plain_jvp(plain, (x, weight, bias) + (shift,) * has,
                       (tx, tweight, tbias) + (tshift,) * has)
        return t, None, None

    @staticmethod
    def vmap(info, in_dims, x, weight, bias, shift, groups, eps, silu):
        outs = []
        for i in range(info.batch_size):
            args = [t if t is None or d is None else t.select(d, i)
                    for t, d in zip((x, weight, bias, shift), in_dims[:4])]
            if _layout(args[0]) is None:  # a slice of a batch-major stack
                args[0] = args[0].contiguous(memory_format=torch.channels_last)
            outs.append(_GroupNorm.apply(*args, groups, eps, silu))
        return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


def group_norm(x, weight, bias, groups: int, eps: float, *,
               shift: Optional[torch.Tensor] = None, silu: bool = False):
    """``act((x + shift[:, :, None, None]) * a + b)`` on x (B, C, H, W), the
    statistics in fp32 (see the module docstring). CUDA tensors take the
    kernel, CPU tensors the plain version, through one autograd Function;
    operands the kernel does not take raise on either."""
    return _GroupNorm.apply(x, weight, bias, shift, int(groups), float(eps), bool(silu))[0]


# launches by configuration (SiLU or none)
group_norm.launches = {"silu": 0, "plain": 0}
