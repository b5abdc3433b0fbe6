"""Products shared by the plain references, each through ``_precision.q``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference._precision import q

# per output phase d of an axis: the source offsets the 3 taps of a 3x3
# convolution over the nearest-2x repeat read, as a (2, 3) fold of the taps:
# phase 0 reads (-1 | 0, +1) -> rows (i - 1, i); phase 1 (-1, 0 | +1) -> (i, i + 1)
_FOLD = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]],
                      [[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.float()
    return F.linear(q(x), q(layer.weight), b)


def conv(layer: nn.Conv2d, x: torch.Tensor, stride: int = 1, pad=None) -> torch.Tensor:
    """``layer``'s convolution of x (B, C, H, W); ``pad`` (left, right, top,
    bottom) zero padding in place of the layer's own."""
    b = None if layer.bias is None else layer.bias.float()
    if pad is None:
        return F.conv2d(q(x), q(layer.weight), b, layer.stride, layer.padding)
    return F.conv2d(F.pad(q(x), pad), q(layer.weight), b, stride)


def upsample_conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (3x3, padding 1) over the nearest 2x repeat of x, computed
    as what it is: each of the four output phases a 2x2 convolution of x
    with the taps that phase reads folded together (the least work; exact
    in real arithmetic)."""
    b, _, h, w = x.shape
    wt = layer.weight.float()
    fold = _FOLD.to(wt.device)
    bias = layer.bias.float()
    out = torch.empty((b, wt.shape[0], 2 * h, 2 * w), device=x.device)
    xq = q(x)
    for di in (0, 1):
        for dj in (0, 1):
            k = torch.einsum("au,bv,fcuv->fcab", fold[di], fold[dj], wt)
            pad = (1 - dj, dj, 1 - di, di)
            out[:, :, di::2, dj::2] = F.conv2d(F.pad(xq, pad), q(k), bias)
    return out
