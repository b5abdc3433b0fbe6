"""DDPM-style UNet score network of the CIFAR stack, and the normalisation
layers with float32 statistics that both model families use (port of
``superdiff_tpu/models/unet.py``, plus flax's ``nn.LayerNorm(dtype=f32)``
for the SD stack).

``ScoreUNet`` keeps the JAX module's public layout (NHWC images in, fp32
NHWC sigma-scaled scores out) and its numerics: parameters stay fp32 and are
cast to the compute dtype at each use, as Flax's ``dtype=`` layers do;
GroupNorm statistics and the attention softmax are fp32; GroupNorm eps is
1e-6; ``t`` enters the sinusoidal embedding unscaled. Inside, activations
are NCHW tensors in ``channels_last`` memory, so the per-pixel ``Dense``
layers (the resnet shortcut, attention q/k/v/out) are ``nn.Linear`` over a
free NHWC view and cuDNN runs its NHWC convolutions.

Children carry Flax's auto-names (``ResnetBlock_0..``, ``AttnBlock_0..``,
``Downsample_0..``, ``Conv_0``, ``Dense_0``, ``Embed_0``; inside a block
``GroupNorm32_k``, ``Conv_k``, ``Dense_k``), so ``models/from_jax.py`` maps
a Flax parameter tree path by path. The layers Flax builds with
``kernel_init=zeros`` are marked with ``flax_zeros``: a net drawn by
``init_like_flax_`` outputs exactly 0, as one fresh from ``model.init`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group_norm import group_norm
from ..utils import profiling
from .from_jax import flax_zeros


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, an optional per-channel input shift
    and an optional SiLU.

    Works on (B, C, *spatial). Groups are the largest divisor of C that is
    <= ``num_groups``. ``forward(x, shift=None, silu=False)`` returns
    ``act((x + shift[:, :, None, None]) * a + b)``: each group's mean and
    fast variance ``max(E[x^2] - E[x]^2, 0)`` are taken in fp32 over the
    fp32 value of ``x + shift`` and folded into a per-(batch, channel)
    ``a``, ``b``; the apply is done in fp32 and rounded once to x's dtype,
    as XLA's fusion of the JAX module (with the sum before it and the SiLU
    after it) computes it. Every tensor goes through
    ``ops.group_norm.group_norm``: CUDA tensors take the hand-written
    kernel, CPU tensors its plain version, under one autograd Function
    (one backward, forward-mode and vmap rule on either device).
    """

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                silu: bool = False) -> torch.Tensor:
        profiling.count("group_norms")
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, shift=shift,
                          silu=silu)


class LayerNorm32(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: fp32 output, fast variance
    clamped at 0, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp(x.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


def timestep_freqs(dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """The embedding's (dim // 2,) fp32 frequencies, computed on the CPU."""
    half = dim // 2
    log_max = torch.log(torch.tensor(max_period, dtype=torch.float32, device="cpu"))
    return torch.exp(-log_max * torch.arange(half, dtype=torch.float32, device="cpu")
                     / (half - 1))


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0,
                       freqs: Optional[torch.Tensor] = None):
    """Sinusoidal timestep embedding (DDPM convention): exponent
    ``arange(half) / (half - 1)``, sin first. ``t`` is used as given (callers
    pre-scale). ``freqs``: :func:`timestep_freqs` already on ``t``'s device.
    Returns (B, dim) float32."""
    if freqs is None:
        freqs = timestep_freqs(dim, max_period).to(t.device)
    args = t.float().reshape(-1, 1) * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class _Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``: fp32 parameters cast to the compute dtype
    at use. Applied to the last axis (the channels of an NHWC view)."""

    def __init__(self, features_in: int, features: int, dtype):
        super().__init__(features_in, features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class _Conv(nn.Conv2d):
    """Flax ``nn.Conv(dtype=...)`` on NCHW: fp32 parameters cast at use."""

    def __init__(self, cin: int, cout: int, dtype, stride: int = 1, padding: int = 1):
        super().__init__(cin, cout, 3, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.conv2d(x.to(d), self.weight.to(d), self.bias.to(d), self.stride,
                        self.padding)


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: in ``train()`` mode each element is kept with
    probability ``1 - rate`` (a uniform draw below it) and the kept ones are
    scaled by ``1 / (1 - rate)`` in the input's dtype; the identity at rate
    0 and in ``eval()``. The masks come from ``generator`` (the caller's
    explicit stream, as JAX's ``rngs={"dropout": key}``), or from the
    default generator of the input's device when it is None.

    ``shards = (num_shards, shard_index)``: ``x`` is one of ``num_shards``
    equal slices of a data-parallel batch; the mask is drawn for the whole
    batch and this slice's rows are kept, so the ranks, which share one
    generator state, draw what one process would (``ScoreUNet.shard_dropout``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.shards = (1, 0)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        n, i = self.shards
        b = x.shape[0]
        u = torch.rand((n * b,) + tuple(x.shape[1:]), generator=generator, device=x.device)
        mask = u[i * b:(i + 1) * b] < keep
        return torch.where(mask, x / keep, 0.0)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, dtype=torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        # eps 1e-6: flax nn.GroupNorm's default, as the reference ScoreNet uses
        self.GroupNorm32_0 = GroupNorm32(in_ch, eps=1e-6)
        self.Conv_0 = _Conv(in_ch, out_ch, dtype)
        self.Dense_0 = _Dense(temb_ch, out_ch, dtype)
        self.GroupNorm32_1 = GroupNorm32(out_ch, eps=1e-6)
        self.dropout = Dropout(dropout)
        self.Conv_1 = flax_zeros(_Conv(out_ch, out_ch, dtype))
        self.Dense_1 = _Dense(in_ch, out_ch, dtype) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.Conv_0(self.GroupNorm32_0(x, silu=True))
        te = self.Dense_0(F.silu(temb)).expand(h.shape[0], -1)  # a scalar t: one row
        h = self.GroupNorm32_1(h, shift=te, silu=True)
        h = self.Conv_1(self.dropout(h, generator))
        if self.Dense_1 is not None:  # per-pixel shortcut on the NHWC view
            x = self.Dense_1(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + h


class AttnBlock(nn.Module):
    """Self-attention over the pixels: logits formed in the compute dtype,
    then cast to fp32, scaled and softmaxed (jvp-friendly plain einsums)."""

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(ch, eps=1e-6)
        self.Dense_0 = _Dense(ch, ch, dtype)
        self.Dense_1 = _Dense(ch, ch, dtype)
        self.Dense_2 = _Dense(ch, ch, dtype)
        self.Dense_3 = flax_zeros(_Dense(ch, ch, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.GroupNorm32_0(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.Dense_0(h), self.Dense_1(h), self.Dense_2(h)
        logits = torch.einsum("bqc,bkc->bqk", q, k).float() * (c**-0.5)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bqk,bkc->bqc", attn, v)
        out = self.Dense_3(out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + out


def _same_pad(n: int) -> tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding of a 3-tap stride-2 window over ``n``."""
    total = max((math.ceil(n / 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


class Downsample(nn.Module):
    """With a conv: a stride-2 3x3 conv with Flax's ``"SAME"`` padding,
    which on an even input pads 0 before and 1 after (not
    ``Conv2d(padding=1)``'s 1 and 1). Without: a 2x2 average pool, stride 2."""

    def __init__(self, ch: int, dtype=torch.float32, with_conv: bool = True):
        super().__init__()
        self.Conv_0 = _Conv(ch, ch, dtype, stride=2, padding=0) if with_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.Conv_0 is None:
            return F.avg_pool2d(x, 2, 2)
        (top, bottom), (left, right) = (_same_pad(n) for n in x.shape[2:])
        return self.Conv_0(F.pad(x, (left, right, top, bottom)))


class Upsample(nn.Module):
    """Nearest 2x, then (``with_conv``) a 3x3 conv."""

    def __init__(self, ch: int, dtype=torch.float32, with_conv: bool = True):
        super().__init__()
        self.Conv_0 = _Conv(ch, ch, dtype) if with_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x if self.Conv_0 is None else self.Conv_0(x)


class ScoreUNet(nn.Module):
    """UNet predicting the sigma-scaled score (``-eps_hat`` convention).

    ``forward(t, x, y=None)``: ``t`` broadcastable to (B, 1, 1, 1), ``x``
    NHWC, integer labels ``y`` (B,) when ``num_classes`` is set; returns fp32
    NHWC. ``image_size`` and ``in_channels`` fix at construction what the
    Flax module reads from its first input (where attention sits, the output
    channels). ``dropout`` acts after each resnet block's second GroupNorm
    and swish in ``train()`` mode, its masks drawn from ``forward``'s
    ``generator``; ``resamp_with_conv=False`` resamples with a 2x2 average
    pool down and a nearest 2x up, without their convs.
    """

    def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16, 8),
                 dropout: float = 0.1, resamp_with_conv: bool = True,
                 num_classes: Optional[int] = None, dtype=torch.float32,
                 image_size: int = 32, in_channels: int = 3):
        super().__init__()
        self.nf, self.dtype = nf, dtype
        self._counts: dict[str, int] = {}
        temb_ch = 4 * nf
        self.Dense_0 = _Dense(nf, temb_ch, dtype)
        # built on the CPU once, so a forward copies nothing from the host
        self.register_buffer("temb_freqs", timestep_freqs(nf).to(self.Dense_0.weight.device),
                             persistent=False)
        self.Dense_1 = _Dense(temb_ch, temb_ch, dtype)
        self.Embed_0 = nn.Embedding(num_classes, temb_ch) if num_classes is not None else None
        self.Conv_0 = _Conv(in_channels, nf, dtype)

        def res_block(cin, cout):
            return self._child("ResnetBlock", ResnetBlock(cin, cout, temb_ch, dtype, dropout))

        def attn_block(c):
            return self._child("AttnBlock", AttnBlock(c, dtype))

        ch, res, skips = nf, image_size, [nf]
        self._down = []  # per level: ([(resnet, attn or None)], downsample or None)
        for level, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                name = res_block(ch, nf * mult)
                ch = nf * mult
                blocks.append((name, attn_block(ch) if res in attn_resolutions else None))
                skips.append(ch)
            down = None
            if level != len(ch_mult) - 1:
                down = self._child("Downsample", Downsample(ch, dtype, resamp_with_conv))
                skips.append(ch)
                res = math.ceil(res / 2)
            self._down.append((blocks, down))
        self._mid = (res_block(ch, ch), attn_block(ch), res_block(ch, ch))
        self._up = []  # per level: ([resnet], attn or None, upsample or None)
        for level in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(res_block(ch + skips.pop(), nf * ch_mult[level]))
                ch = nf * ch_mult[level]
            attn = attn_block(ch) if res in attn_resolutions else None
            up = None
            if level != 0:
                up = self._child("Upsample", Upsample(ch, dtype, resamp_with_conv))
                res *= 2
            self._up.append((blocks, attn, up))
        assert not skips
        self.GroupNorm32_0 = GroupNorm32(ch, eps=1e-6)
        self.Conv_1 = flax_zeros(_Conv(ch, in_channels, dtype))

    def _child(self, kind: str, module: nn.Module) -> str:
        """Register ``module`` under Flax's next auto-name for ``kind``."""
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return f"{kind}_{i}"

    def shard_dropout(self, num_shards: int, shard_index: int) -> "ScoreUNet":
        """Draw every dropout mask for a batch ``num_shards`` times this
        module's and keep the ``shard_index``-th slice (data-parallel
        training, ``pipelines.cifar.train``); (1, 0) is one process."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.shards = (num_shards, shard_index)
        return self

    def forward(self, t, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        temb = self.Dense_0(timestep_embedding(t.reshape(-1), self.nf,
                                                freqs=self.temb_freqs).to(dt))
        temb = self.Dense_1(F.silu(temb))
        if self.Embed_0 is not None:
            if y is None:
                raise ValueError("a class-conditioned ScoreUNet needs labels y")
            temb = temb + self.Embed_0(y.long()).to(dt)
        sub = self.get_submodule

        h = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        hs = [self.Conv_0(h)]
        for blocks, down in self._down:
            for res, attn in blocks:
                h = sub(res)(hs[-1], temb, generator)
                if attn is not None:
                    h = sub(attn)(h)
                hs.append(h)
            if down is not None:
                hs.append(sub(down)(hs[-1]))
        res0, attn, res1 = self._mid
        h = sub(res1)(sub(attn)(sub(res0)(hs[-1], temb, generator)), temb, generator)
        for blocks, attn, up in self._up:
            for res in blocks:
                h = sub(res)(torch.cat([h, hs.pop()], dim=1), temb, generator)
            if attn is not None:
                h = sub(attn)(h)
            if up is not None:
                h = sub(up)(h)
        assert not hs
        h = self.Conv_1(self.GroupNorm32_0(h, silu=True))
        return h.permute(0, 2, 3, 1).float()
