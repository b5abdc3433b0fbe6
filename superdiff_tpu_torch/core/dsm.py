"""Denoising score-matching loss and low-discrepancy time sampling (port of
``superdiff_tpu/core/dsm.py``).

Epsilon-matching under the VP forward kernel (``cifar/dynamics.py:29-45``),
with the Kronecker (additive-recurrence) time sampler, whose cursor is a
float32 scalar carried in the training state. The cursor's arithmetic is
float32 throughout, as in JAX: the next batch's times depend on its bits.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch


def kronecker_times(
    batch_size: int,
    u0: torch.Tensor,
    t_0: float,
    t_1: float,
    *,
    num_shards: int = 1,
    shard_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-discrepancy time grid: ``(u0 + sqrt(2) * arange) mod 1`` in fp32.

    The global sequence spans ``batch_size * num_shards`` points; shard
    ``shard_index`` takes its contiguous slice (``cifar/dynamics.py:9-13``).
    ``u0`` is a 0-d float32 tensor. Returns (t (batch_size,), next_u0 0-d),
    on ``u0``'s device.
    """
    u0 = torch.as_tensor(u0, dtype=torch.float32)
    n = batch_size * num_shards
    u = torch.remainder(u0 + math.sqrt(2.0) * torch.arange(n, dtype=torch.float32,
                                                           device=u0.device), 1.0)
    lo = shard_index * batch_size
    t = (t_1 - t_0) * u[lo:lo + batch_size] + t_0
    return t, u[-1]


def make_dsm_loss(
    apply_fn: Callable[..., torch.Tensor],
    schedule,
    *,
    t_0: float = 0.0,
    t_1: float = 1.0,
    num_shards: int = 1,
    shard_index: int = 0,
):
    """Epsilon-matching DSM loss closure.

    ``apply_fn(t, x, y, generator)`` returns the model's sigma-scaled score
    prediction (the ``-eps_hat`` convention; a module's ``forward``, its
    dropout drawing from ``generator``). The loss is ``mean_b sum_event
    (eps + pred)^2`` (``cifar/dynamics.py:43-45``).

    Returns ``loss_fn(sampler_state, batch, *, generator=None, eps=None) ->
    (loss, next_sampler_state)``: ``batch`` holds ``"image"`` (B, *event)
    and optionally ``"label"`` (B,); ``eps`` the unit normals (B, *event),
    drawn from ``generator`` on the image's device when not given (the tests
    hand in JAX's threefry draw, which torch cannot reproduce).

    ``num_shards`` / ``shard_index``: ``batch`` is one of ``num_shards``
    equal slices of a global batch. The times are that slice of the global
    Kronecker sequence (as in JAX) and a drawn ``eps`` is the global
    batch's draw, sliced: data-parallel ranks share one generator state,
    and each then draws what one process draws for its rows (JAX draws the
    local shape from a replicated key, so its shards share their draws).
    """

    def loss_fn(sampler_state, batch, *, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        data = batch["image"]
        labels = batch.get("label")
        bs = data.shape[0]
        t, next_state = kronecker_times(bs, sampler_state, t_0, t_1,
                                        num_shards=num_shards, shard_index=shard_index)
        t = t.reshape((bs,) + (1,) * (data.ndim - 1))
        if eps is None:
            # the global batch's draw, this shard's rows of it
            full = (bs * num_shards,) + tuple(data.shape[1:])
            eps = torch.randn(full, generator=generator, dtype=data.dtype,
                              device=data.device)[shard_index * bs:(shard_index + 1) * bs]
        x_t = schedule.marginal(data, eps, t)
        pred = apply_fn(t, x_t, labels, generator)
        per_sample = torch.sum((eps + pred) ** 2, dim=tuple(range(1, data.ndim)))
        return per_sample.mean(), next_state

    return loss_fn
