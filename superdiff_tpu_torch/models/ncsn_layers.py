"""NCSNv1/v2 RefineNet layer zoo: CRP / RCU / MSF / Refine blocks and the
conv / mean-pool pairs (port of ``superdiff_tpu/models/ncsn_layers.py``;
behavioural parity with ``cifar/models/layers.py:117-340``).

Each family is one stage recipe shared by its plain and conditional
flavour: the conditional one threads a normalizer, taking ``(h, y)``, in
front of each conv (and CRP's pool switches from max to average, as the
reference's v1 / v2 split does). NCHW, fp32 normalization statistics.

Where the Flax modules infer channel counts from their input, a torch
module owns its weights from construction, so the blocks that see inputs
of other widths take them: ``MSFBlock`` / ``RefineBlock`` (and their
conditional forms) take ``in_planes``, one count per input scale, and
``ConvMeanPool`` / ``MeanPoolConv`` take ``input_dim``. A normalizer is a
constructor ``normalizer(num_features) -> module(h, y)``, as
``normalization.get_normalization(..., conditional=True)`` returns.
Children carry the Flax auto-names (``Conv_0``,
``ConditionalInstanceNorm2dPlus_1``, ``CondRCUBlock_2``), so
``models/from_jax.py::ncsn_from_flax`` carries a Flax tree across.

Flax's SAME padding and pools are kept as they are: convs pad
``(k_eff - 1) // 2`` before and the rest after; the 5x5 average pool
counts the zero padding, the max pool pads with -inf. ``jax.image.resize``
(half-pixel centres; a triangle kernel widened by the scale, so
antialiased, when it shrinks) is ``F.interpolate(..., antialias=True)``
for bilinear and ``"nearest-exact"`` for nearest.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax's ``padding="SAME"``: ``ceil(in / stride)``
    outputs, the padding split low-first as XLA splits it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s, dil in zip(reversed(x.shape[2:]), reversed(self.kernel_size),
                                   reversed(self.stride), reversed(self.dilation)):
            k_eff = (k - 1) * dil + 1
            total = max((math.ceil(size / s) - 1) * s + k_eff - size, 0)
            pads += [total // 2, total - total // 2]
        return self._conv_forward(F.pad(x, pads), self.weight, self.bias)


def ncsn_conv3x3(in_planes: int, out_planes: int, stride: int = 1, bias: bool = True,
                 dilation: int = 1, init_scale: float = 1.0) -> SameConv2d:
    """3x3 conv with NCSN's torch-style init (``layers.py:77-93``):
    variance_scaling(scale / 3, fan_in, uniform) for the kernel and, drawn
    from the same distribution, the bias."""
    conv = SameConv2d(in_planes, out_planes, 3, stride=stride, dilation=dilation, bias=bias)
    bound = math.sqrt((1e-10 if init_scale == 0 else init_scale) / (in_planes * 9))
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound)
        if bias:
            conv.bias.uniform_(-bound, bound)
    return conv


class _Stages(nn.Module):
    """Children under Flax's auto-names (``<class>_<n>``, each class
    counting its own; a conv is Flax's ``Conv``)."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def _add(self, module: nn.Module, cls: Optional[str] = None) -> nn.Module:
        cls = cls or type(module).__name__
        n = self._counts.get(cls, 0)
        self._counts[cls] = n + 1
        self.add_module(f"{cls}_{n}", module)
        return module

    def _conv(self, in_planes: int, out_planes: int, bias: bool) -> nn.Module:
        return self._add(ncsn_conv3x3(in_planes, out_planes, bias=bias), "Conv")


def _norm(normalizer, features: int):
    return normalizer(features) if normalizer is not None else None


def _apply(norm: Optional[nn.Module], h: torch.Tensor, y) -> torch.Tensor:
    return h if norm is None else norm(h, y)


class _CRP(_Stages):
    """Chained residual pooling trunk (``layers.py:117-153``): ``n_stages``
    pool + conv refinements of a running path, each summed into the trunk.
    Conditional: normalize first and average-pool; plain: max-pool."""

    def __init__(self, features: int, n_stages: int, act: Callable, normalizer):
        super().__init__()
        self.act, self.cond = act, normalizer is not None
        self.stages = [(self._add(_norm(normalizer, features)) if self.cond else None,
                        self._conv(features, features, False))
                       for _ in range(n_stages)]

    def run(self, x: torch.Tensor, y) -> torch.Tensor:
        x = self.act(x)
        path = x
        for norm, conv in self.stages:
            path = _apply(norm, path, y)
            path = (F.avg_pool2d(path, 5, 1, 2, count_include_pad=True) if self.cond
                    else F.max_pool2d(path, 5, 1, 2))
            path = conv(path)
            x = path + x
        return x


class _RCU(_Stages):
    """Residual conv units (``layers.py:155-192``): ``n_blocks`` residual
    blocks of ``n_stages`` (norm?) - act - conv chains."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable, normalizer):
        super().__init__()
        self.act = act
        self.blocks = [[(self._add(_norm(normalizer, features)) if normalizer else None,
                         self._conv(features, features, False))
                        for _ in range(n_stages)] for _ in range(n_blocks)]

    def run(self, x: torch.Tensor, y) -> torch.Tensor:
        for block in self.blocks:
            residual = x
            for norm, conv in block:
                x = conv(self.act(_apply(norm, x, y)))
            x = x + residual
        return x


def _resize(h: torch.Tensor, shape: Sequence[int], interpolation: str) -> torch.Tensor:
    if interpolation == "bilinear":
        return F.interpolate(h, size=tuple(shape), mode="bilinear", align_corners=False,
                             antialias=True)
    if interpolation == "nearest_neighbor":
        return F.interpolate(h, size=tuple(shape), mode="nearest-exact")
    raise ValueError(f"unknown interpolation: {interpolation}")


class _MSF(_Stages):
    """Multi-scale fusion (``layers.py:194-235``): (norm?) - conv each
    scale, resize everything to the common ``shape``, sum."""

    def __init__(self, in_planes: Sequence[int], shape: Sequence[int], features: int,
                 interpolation: str, normalizer):
        super().__init__()
        self.shape, self.interpolation = tuple(shape), interpolation
        self.scales = [(self._add(_norm(normalizer, c)) if normalizer else None,
                        self._conv(c, features, True))
                       for c in in_planes]

    def run(self, xs: Sequence[torch.Tensor], y) -> torch.Tensor:
        total = None
        for (norm, conv), x in zip(self.scales, xs):
            h = _resize(conv(_apply(norm, x, y)), self.shape, self.interpolation)
            total = h if total is None else total + h
        return total


class CRPBlock(_CRP):
    """Chained residual pooling (``layers.py:117-134``)."""

    def __init__(self, features: int, n_stages: int = 2, act: Callable = F.relu):
        super().__init__(features, n_stages, act, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x, None)


class CondCRPBlock(_CRP):
    """Noise-conditional CRP (``layers.py:136-153``)."""

    def __init__(self, features: int, normalizer, n_stages: int = 2, act: Callable = F.relu):
        super().__init__(features, n_stages, act, normalizer)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.run(x, y)


class RCUBlock(_RCU):
    """Residual conv unit (``layers.py:155-172``)."""

    def __init__(self, features: int, n_blocks: int = 2, n_stages: int = 2,
                 act: Callable = F.relu):
        super().__init__(features, n_blocks, n_stages, act, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x, None)


class CondRCUBlock(_RCU):
    """Noise-conditional RCU (``layers.py:174-192``)."""

    def __init__(self, features: int, normalizer, n_blocks: int = 2, n_stages: int = 2,
                 act: Callable = F.relu):
        super().__init__(features, n_blocks, n_stages, act, normalizer)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.run(x, y)


class MSFBlock(_MSF):
    """Multi-scale fusion (``layers.py:194-212``)."""

    def __init__(self, in_planes: Sequence[int], shape: Sequence[int], features: int,
                 interpolation: str = "bilinear"):
        super().__init__(in_planes, shape, features, interpolation, None)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.run(xs, None)


class CondMSFBlock(_MSF):
    """Noise-conditional MSF (``layers.py:214-235``)."""

    def __init__(self, in_planes: Sequence[int], shape: Sequence[int], features: int,
                 normalizer, interpolation: str = "bilinear"):
        super().__init__(in_planes, shape, features, interpolation, normalizer)

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
        return self.run(xs, y)


class _Refine(_Stages):
    """RefineNet block recipe (``layers.py:237-317``): per-scale RCU,
    multi-scale fusion (skipped at the pyramid start), chained pooling,
    then a deeper output RCU at the pyramid end."""

    def __init__(self, in_planes, output_shape, features, act, interpolation, start, end,
                 normalizer):
        super().__init__()
        self.cond = normalizer is not None

        def rcu(c, n_blocks):
            if self.cond:
                return CondRCUBlock(c, normalizer, n_blocks=n_blocks, n_stages=2, act=act)
            return RCUBlock(c, n_blocks=n_blocks, n_stages=2, act=act)

        # plain containers: the children are registered under their Flax names
        self.rcus = [self._add(rcu(c, 2)) for c in in_planes]
        msf = None if start else self._add(
            CondMSFBlock(in_planes, output_shape, features, normalizer, interpolation)
            if self.cond else MSFBlock(in_planes, output_shape, features, interpolation))
        crp = self._add(CondCRPBlock(features, normalizer, n_stages=2, act=act)
                        if self.cond else CRPBlock(features, n_stages=2, act=act))
        self.tail = (msf, crp, self._add(rcu(features, 3 if end else 1)))

    def run(self, xs: Sequence[torch.Tensor], y) -> torch.Tensor:
        args = (y,) if self.cond else ()
        msf, crp, out_rcu = self.tail
        hs = [m(x, *args) for m, x in zip(self.rcus, xs)]
        h = msf(hs, *args) if msf is not None else hs[0]
        return out_rcu(crp(h, *args), *args)


class RefineBlock(_Refine):
    """RefineNet block for NCSNv2 (``layers.py:237-273``)."""

    def __init__(self, in_planes: Sequence[int], output_shape: Sequence[int], features: int,
                 act: Callable = F.relu, interpolation: str = "bilinear", start: bool = False,
                 end: bool = False):
        super().__init__(in_planes, output_shape, features, act, interpolation, start, end, None)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.run(xs, None)


class CondRefineBlock(_Refine):
    """Noise-conditional RefineNet block for NCSNv1 (``layers.py:275-317``)."""

    def __init__(self, in_planes: Sequence[int], output_shape: Sequence[int], features: int,
                 normalizer, act: Callable = F.relu, interpolation: str = "bilinear",
                 start: bool = False, end: bool = False):
        super().__init__(in_planes, output_shape, features, act, interpolation, start, end,
                         normalizer)

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
        return self.run(xs, y)


def _mean_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 mean pool as the reference writes it: the average of
    the four phase-shifted stride-2 slices (``layers.py:330-336``)."""
    return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2]
            + x[:, :, ::2, 1::2] + x[:, :, 1::2, 1::2]) / 4.0


class _PoolConvPair(nn.Module):
    """Shared body of the conv / mean-pool pairs (``layers.py:319-358``);
    ``pool_first`` selects the composition order."""

    pool_first = False

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.Conv_0 = SameConv2d(input_dim, output_dim, kernel_size, bias=biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_first:
            return self.Conv_0(_mean_pool_2x2(x))
        return _mean_pool_2x2(self.Conv_0(x))


class ConvMeanPool(_PoolConvPair):
    """Conv then 2x2 mean-pool (``layers.py:319-338``)."""


class MeanPoolConv(_PoolConvPair):
    """2x2 mean-pool then conv (``layers.py:340-358``)."""

    pool_first = True
