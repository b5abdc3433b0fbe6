"""Toy MLP score network for low-dimensional experiments (port of
``superdiff_tpu/models/mlp.py``): small enough to train in seconds, the
executable spec of the superposition algorithm in the tests."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .from_jax import flax_zeros


class MLPScoreNet(nn.Module):
    """MLP score net: ``forward(t, x, y=None)`` -> sigma-scaled score of
    x's dimension ``out_dim`` (x is (B, out_dim), ``t`` a scalar or one per
    row). Six Fourier frequencies ``2^k pi`` of t join x at the input; swish
    hidden layers; the output layer starts at zero, as the Flax module's
    ``kernel_init=zeros``. Children ``Dense_0..`` carry Flax's auto-names,
    so ``models/from_jax.py`` carries a Flax tree across."""

    def __init__(self, hidden: Sequence[int] = (256, 256, 256), out_dim: int = 2):
        super().__init__()
        widths = [out_dim + 12, *hidden]
        for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"Dense_{i}", nn.Linear(w_in, w_out))
        self.add_module(f"Dense_{len(hidden)}", flax_zeros(nn.Linear(widths[-1], out_dim)))
        self.n_hidden = len(hidden)

    def forward(self, t, x: torch.Tensor, y=None) -> torch.Tensor:
        del y
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        t = torch.broadcast_to(t.reshape(-1, 1), (x.shape[0], 1))
        freqs = 2.0 ** torch.arange(6, dtype=x.dtype, device=x.device) * math.pi
        h = torch.cat([x, torch.sin(t * freqs), torch.cos(t * freqs)], dim=-1)
        for i in range(self.n_hidden):
            h = F.silu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n_hidden}")(h)
