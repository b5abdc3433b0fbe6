"""Normalization zoo for score networks (port of
``superdiff_tpu/models/normalization.py``).

Functional coverage of the reference's ``cifar/models/normalization.py``
(GroupNorm selector + variance / instance variants, conditional forms):
the ScoreUNet uses fp32 GroupNorm (``unet.GroupNorm32``); the variants
here exist for config-compatible experimentation. All are NCHW, compute
their statistics in fp32 and return the input's dtype. Each takes the
channel count first; the Flax modules' (1, 1, 1, C) parameters are (C,)
here (``models/from_jax.py::ncsn_from_flax`` reshapes them).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn

from .unet import GroupNorm32

_EPS = 1e-5


def _stats(xf: torch.Tensor):
    """Per-(sample, channel) spatial mean and (biased) variance, fp32."""
    return xf.mean(dim=(2, 3), keepdim=True), xf.var(dim=(2, 3), unbiased=False, keepdim=True)


def _chan(p: torch.Tensor) -> torch.Tensor:
    return p.view(1, -1, 1, 1)


def _near_one(c: int) -> nn.Parameter:
    return nn.Parameter(1.0 + 0.02 * torch.randn(c))


class VarianceNorm2d(nn.Module):
    """Scale-only normalization by per-channel spatial variance."""

    def __init__(self, num_features: int, bias: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(0.02 * torch.randn(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, var = _stats(x.float())
        h = x / torch.sqrt(var + _EPS)
        h = h * (1.0 + _chan(self.alpha))
        if self.beta is not None:
            h = h + _chan(self.beta)
        return h.to(x.dtype)


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel spatial normalization."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _stats(x.float())
        h = (x - mean) / torch.sqrt(var + _EPS) * _chan(self.gamma)
        if self.beta is not None:
            h = h + _chan(self.beta)
        return h.to(x.dtype)


def _plus_terms(x: torch.Tensor):
    """InstanceNorm++'s normalized activations and the normalized
    cross-channel means, fp32: (h (B, C, H, W), means_norm (B, C))."""
    xf = x.float()
    means, var = _stats(xf)
    means = means[:, :, 0, 0]
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, unbiased=False, keepdim=True)
    means_norm = (means - m) / torch.sqrt(v + _EPS)
    h = (xf - means[:, :, None, None]) / torch.sqrt(var + _EPS)
    return h, means_norm


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++ (NCSN): re-injects the cross-channel mean statistic so
    colour information survives normalization; the statistic is added
    before the gamma scaling (``normalization.py:96-100``)."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = _near_one(num_features)
        self.gamma = _near_one(num_features)
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, means_norm = _plus_terms(x)
        h = h + means_norm[:, :, None, None] * _chan(self.alpha)
        h = h * _chan(self.gamma)
        if self.beta is not None:
            h = h + _chan(self.beta)
        return h.to(x.dtype)


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Conditional InstanceNorm++ (NCSNv1): per-class embedded (gamma,
    alpha[, beta]) modulate the InstanceNorm++ statistics
    (``cifar/models/normalization.py:106-145``). ``y`` is an integer class /
    noise-level index of shape (B,)."""

    def __init__(self, num_features: int, num_classes: int = 10, bias: bool = True):
        super().__init__()
        c = num_features
        self.bias = bias
        self.Embed_0 = nn.Embedding(num_classes, 3 * c if bias else 2 * c)
        with torch.no_grad():  # gamma / alpha start near 1, beta at 0
            self.Embed_0.weight.zero_()
            self.Embed_0.weight[:, :2 * c] = 1.0 + 0.02 * torch.randn(num_classes, 2 * c)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h, means_plus = _plus_terms(x)
        embed = self.Embed_0(y)
        parts = embed.chunk(3 if self.bias else 2, dim=-1)
        gamma, alpha = parts[0], parts[1]
        h = h + (means_plus * alpha)[:, :, None, None]
        out = gamma[:, :, None, None] * h
        if self.bias:
            out = out + parts[2][:, :, None, None]
        return out.to(x.dtype)


def get_normalization(name: str = "GroupNorm", conditional: bool = False,
                      num_classes: int = 10) -> Callable[..., nn.Module]:
    """Selector mirroring ``normalization.py:23-41``: a constructor taking
    the channel count. Conditional variants take (x, y-index); as in the
    reference, only InstanceNorm++ has a conditional form."""
    table = {
        "GroupNorm": GroupNorm32,
        "VarianceNorm": VarianceNorm2d,
        "InstanceNorm": InstanceNorm2d,
        "InstanceNorm++": InstanceNorm2dPlus,
    }
    if name not in table:
        raise ValueError(f"unknown normalization: {name}")
    if conditional:
        if name == "InstanceNorm++":
            return functools.partial(ConditionalInstanceNorm2dPlus, num_classes=num_classes)
        raise NotImplementedError(f"{name} has no conditional variant")
    return table[name]
