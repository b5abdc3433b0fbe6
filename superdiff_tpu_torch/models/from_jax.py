"""Weights as the JAX package has them: carried over from its Flax parameter
trees, or drawn from the distributions of its Flax initialisers.

The port's modules carry the Flax module names, so the carrier is
mechanical: a Flax path ``down_0_res_0/conv1/kernel`` becomes the
``state_dict`` key ``down_0_res_0.conv1.weight``, with

* HWIO conv kernels -> OIHW, (in, out) dense kernels -> (out, in);
* the GEGLU ``ff_geglu/proj`` kernel (C, 2, F) -> (2F, C) and its bias
  (2, F) -> (2F,), value half first;
* ``GroupNorm_0/{scale,bias}`` -> the GroupNorm32 module's ``weight``/``bias``,
  LayerNorm ``scale`` -> ``weight``, ``Embed`` ``embedding`` -> ``weight``.

One carrier serves both model families: the SD-1.x stack (UNet, CLIP text
encoder, VAE decoder) and the CIFAR ``ScoreUNet``, whose children carry
Flax's auto-names (``ResnetBlock_3/Conv_1``). For SD,
``superdiff_tpu/models/sd/convert.py::unet_mapping`` maps diffusers keys onto
these Flax names, so a safetensors loader can chain through it.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a Flax ``params`` tree) -> torch state_dict."""
    out = {}
    for path, a in _flatten(params):
        *mods, leaf = path.replace("/GroupNorm_0/", "/").split("/")
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 3:  # GEGLU (C, 2, F)
                a = a.reshape(a.shape[0], -1).T
            else:
                a = a.T
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf == "bias":
            a = a.reshape(-1)
        out[".".join(mods + [leaf])] = torch.tensor(a)
    return out


def flax_zeros(layer: nn.Module) -> nn.Module:
    """Mark a Linear or Conv2d whose Flax counterpart has
    ``kernel_init=zeros``: :func:`init_like_flax_` zeroes it."""
    layer.flax_zero_init = True
    return layer


def _normal_(w: torch.Tensor, std: float, generator) -> None:
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    tmp.normal_(0.0, std, generator=generator)
    w.copy_(tmp)


@torch.no_grad()
def init_like_flax_(model: nn.Module, generator: torch.Generator | None = None):
    """Redraw ``model``'s parameters with the Flax initialisers' distributions:
    ``lecun_normal`` (truncated normal on +-2 std, variance 1/fan_in) for
    dense and conv kernels, zeros for kernels marked by :func:`flax_zeros`,
    zero biases, fan-in normal ``Embed`` tables, ``normal(0.01)`` position
    embeddings, unit/zero norm params. Draws in fp32 from ``generator`` and
    copies into each parameter's dtype, so the random-weight model has the
    JAX model's activation scales."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            if getattr(m, "flax_zero_init", False):
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                tmp = torch.empty(m.weight.shape, dtype=torch.float32,
                                  device=m.weight.device)
                nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.weight.copy_(tmp)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _normal_(m.weight, 1.0 / math.sqrt(m.embedding_dim), generator)
    for name, p in model.named_parameters():
        if name.endswith("position_embedding"):
            _normal_(p, 0.01, generator)
    return model
