"""Weights and inputs drawn from the run's seed, on the device.

The benchmark owns every weight: it draws them itself, in a few large
calls on the card, loads them into the program and hands the same draw to
its plain reference. Names and shapes come from the reference's modules
built on the ``meta`` device, and each parameter's dtype is the one the
program serves it in.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

State = Dict[str, Dict[str, torch.Tensor]]


def subseed(*ints: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed and the
    numbers of a stream (weights, request i, the check's sample)."""
    return int(np.random.SeedSequence([int(i) for i in ints]).generate_state(1, np.uint64)[0] >> 1)


def generator(device, *ints: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(*ints))


def _std(name: str, shape) -> float:
    """Standard deviation of a parameter's draw; 0 for a constant one."""
    if name.endswith("position_embedding"):
        return 0.01
    if name.endswith("embedding.weight"):
        return 1.0 / math.sqrt(shape[-1])
    if "norm" in name.lower() or name.endswith(".bias"):
        return 0.0
    return 1.0 / math.sqrt(int(np.prod(shape[1:])))


@torch.no_grad()
def draw(parts: Dict[str, nn.Module], served_dtype: Callable[[str, str], torch.dtype],
         seed: int, device) -> State:
    """{part: state dict} for the modules ``parts`` (any device, ``meta``
    included): weights normal with variance 1/fan_in, embeddings as CLIP's,
    norm scales 1, biases and norm offsets 0. One normal draw per served
    dtype, sliced in the order of ``named_parameters``."""
    specs = [(part, name, tuple(p.shape), served_dtype(part, name))
             for part, mod in parts.items() for name, p in mod.named_parameters()]
    gen = generator(device, seed, 0)
    flat, offset = {}, {}
    for dtype in sorted({s[3] for s in specs}, key=str):
        n = sum(int(np.prod(shape)) for _, name, shape, d in specs
                if d == dtype and _std(name, shape) > 0)
        flat[dtype] = torch.randn(n, generator=gen, device=device, dtype=dtype)
        offset[dtype] = 0
    out: State = {part: {} for part in parts}
    for part, name, shape, dtype in specs:
        std = _std(name, shape)
        if std == 0.0:
            fill = 1.0 if "norm" in name.lower() and name.endswith("weight") else 0.0
            out[part][name] = torch.full(shape, fill, dtype=dtype, device=device)
            continue
        n = int(np.prod(shape))
        out[part][name] = (flat[dtype][offset[dtype]:offset[dtype] + n].view(shape) * std)
        offset[dtype] += n
    return out
