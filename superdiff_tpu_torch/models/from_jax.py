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

One carrier serves the SD-1.x stack (UNet, CLIP text encoder, VAE), the
CIFAR ``ScoreUNet``, whose children carry Flax's auto-names
(``ResnetBlock_3/Conv_1``), and the protein ``IPAScoreNetwork``. The
checkpoint-faithful ``FrameDiffScoreNetwork`` and ``ProteusScoreNetwork``
carry the reference's names instead: :func:`protein_net_from_flax` maps
their Flax paths through ``models/protein/convert.py``. For SD,
``models/sd/convert.py`` maps diffusers safetensors keys onto these Flax
paths and chains each one through :func:`flax_leaf_to_torch`.
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


def torch_key(path: str) -> str:
    """The ``state_dict`` key of a Flax parameter's ``/``-separated path."""
    *mods, leaf = path.replace("/GroupNorm_0/", "/").split("/")
    return ".".join(mods + ["weight" if leaf in ("kernel", "scale", "embedding") else leaf])


def flax_leaf_to_torch(path: str, a: np.ndarray) -> tuple[str, torch.Tensor]:
    """One Flax parameter (its path and array) -> its ``state_dict`` key and
    tensor."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "kernel":
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 3:  # GEGLU (C, 2, F)
            a = a.reshape(a.shape[0], -1).T
        else:
            a = a.T
    elif leaf == "bias":
        a = a.reshape(-1)
    return torch_key(path), torch.tensor(a)


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a Flax ``params`` tree) -> torch state_dict."""
    return dict(flax_leaf_to_torch(path, a) for path, a in _flatten(params))


def protein_net_from_flax(net: nn.Module, params: Mapping) -> nn.Module:
    """Load the Flax ``params`` tree of a JAX protein score network into the
    port's ``net`` of the same config, in place; returns ``net``.

    ``IPAScoreNetwork`` carries the Flax names (the generic carrier);
    ``FrameDiffScoreNetwork`` / ``ProteusScoreNetwork`` take each Flax
    leaf to its reference key through the converter's mapping. The keys the
    reference forward never uses (``linear_rbf``, ``torsion_pred.linear_3``,
    the local triangle attention's ``pair_transition``) have no Flax
    counterpart and keep their values; every other key must be covered."""
    from .protein import convert
    from .protein.framediff import FrameDiffScoreNetwork
    from .protein.proteus import ProteusScoreNetwork

    if isinstance(net, (FrameDiffScoreNetwork, ProteusScoreNetwork)):
        if isinstance(net, FrameDiffScoreNetwork):
            mapping = convert.framediff_mapping(net.cfg)
            unused = convert.framediff_unused_keys(net.cfg)
        else:
            mapping = convert.proteus_mapping(net.cfg)
            unused = convert.proteus_unused_keys(net.cfg)
        leaves = dict(_flatten(params))
        sd = {key: torch.tensor(leaves[path].T if tf == "T" else leaves[path])
              for key, path, tf in mapping}
        missing, unexpected = net.load_state_dict(sd, strict=False)
        if set(missing) != set(unused) or unexpected:
            raise KeyError(f"Flax tree does not cover the network: missing "
                           f"{sorted(set(missing) - set(unused))[:5]}, unexpected "
                           f"{unexpected[:5]}")
    else:
        net.load_state_dict(state_dict_from_flax(params), strict=True)
    return net


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


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu), found in a nested
    tuple of optimizer states."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if {"count", "mu", "nu"} <= set(getattr(node, "_fields", ())):
            return node
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("no Adam state (count, mu, nu) in the optimizer state")


@torch.no_grad()
def train_state_from_jax(jax_state, state):
    """Carry a JAX ``TrainState`` (``superdiff_tpu.train.TrainState`` after
    ``jax.device_get``: numpy leaves, its optimizer state optax's
    ``chain(clip, adam(schedule))``) into the port's ``state``
    (``train.TrainState`` of the same model and optimizer spec), in place.

    * ``params`` and ``params_ema`` through :func:`state_dict_from_flax`;
    * Adam's ``mu`` / ``nu`` into each parameter's ``exp_avg`` /
      ``exp_avg_sq``, with the same Flax -> torch transposes;
    * Adam's ``count`` into the optimizer's ``step`` and the schedule's
      step (and so the learning rate of the next update);
    * ``step``, ``sampler_state`` (the fp32 cursor) and ``run_id``.

    JAX's PRNG key (threefry) cannot be carried: the port's generator keeps
    its own seeded state. Returns ``state``."""
    names = [n for n, _ in state.model.named_parameters()]
    params = state_dict_from_flax(jax_state.params)
    ema = state_dict_from_flax(jax_state.params_ema)
    if set(params) != set(names) or set(ema) != set(names):
        raise KeyError("the JAX parameter tree does not match the port's model")
    state.model.load_state_dict(params, strict=True)
    for n in names:
        state.params_ema[n].copy_(ema[n])
    adam = _adam_state(jax_state.opt_state)
    count = int(np.asarray(adam.count))
    mu, nu = state_dict_from_flax(adam.mu), state_dict_from_flax(adam.nu)
    for n, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[n].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[n].to(p.device, p.dtype).clone(),
        }
    lrs = [lam(count) * base for lam, base in zip(state.schedule.lr_lambdas,
                                                  state.schedule.base_lrs)]
    sd = state.schedule.state_dict()
    sd.update(last_epoch=count, _step_count=count + 1, _last_lr=lrs)
    state.schedule.load_state_dict(sd)
    for group, lr in zip(state.optimizer.param_groups, lrs):
        group["lr"] = lr
    state.step = int(np.asarray(jax_state.step))
    state.sampler_state = torch.tensor(np.asarray(jax_state.sampler_state, np.float32),
                                       device=state.sampler_state.device)
    state.run_id = int(jax_state.run_id)
    return state
