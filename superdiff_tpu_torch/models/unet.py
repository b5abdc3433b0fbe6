"""Normalisation layers with float32 statistics (port of ``GroupNorm32`` from
``superdiff_tpu/models/unet.py`` and of the flax ``nn.LayerNorm(dtype=f32)``
the SD stack uses)."""

from __future__ import annotations

import torch
from torch import nn


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, applied in the activation dtype.

    Works on (B, C, *spatial). Groups are the largest divisor of C that is
    <= ``num_groups``. Mean and the fast variance ``max(E[x^2] - E[x]^2, 0)``
    are taken in fp32, folded into a per-(batch, channel) ``x * a + b`` and
    applied in the input's dtype, as the JAX module does.
    """

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.groups, -1)
        mean = xg.mean(-1)
        var = torch.clamp(xg.square().mean(-1) - mean.square(), min=0.0)
        rstd = torch.rsqrt(var + self.eps)
        per_ch = c // self.groups
        a = rstd.repeat_interleave(per_ch, dim=1) * self.weight.float()
        bb = self.bias.float() - mean.repeat_interleave(per_ch, dim=1) * a
        shape = (b, c) + (1,) * (x.ndim - 2)
        return x * a.reshape(shape).to(x.dtype) + bb.reshape(shape).to(x.dtype)


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
