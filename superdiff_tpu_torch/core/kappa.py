"""Mixing-weight (kappa) policies (port of ``superdiff_tpu/core/kappa.py``).

The OR policies (two-model ``kappa_or`` of the SD stack, N-model
``or_weights`` of the CIFAR stack) are ported. Like the JAX package, every policy
works on float32 accumulators: the OR softmax at high temperature is an
argmax in disguise and must not see bf16 rounding noise.
"""

from __future__ import annotations

import torch


def or_weights(logq: torch.Tensor, temperature: float = 1e6) -> torch.Tensor:
    """N-model OR weights: ``softmax(T * logq)`` along the last axis; with the
    reference's T = 1e6 a smooth argmax over the running log-likelihoods
    (``cifar/dynamics.py:90,124``). (B, N) -> (B, N) fp32."""
    return torch.softmax(temperature * logq.float(), dim=-1)


def kappa_or(ll_a: torch.Tensor, ll_b: torch.Tensor, temperature: float = 1.0,
             logp: float = 0.0) -> torch.Tensor:
    """Two-model OR kappa, the weight on model *a*:
    ``softmax([T*(ll_a + logp), T*ll_b])[0]``. Same shape as the inputs."""
    a = temperature * (ll_a.float() + logp)
    b = temperature * ll_b.float()
    m = torch.maximum(a, b)
    ea, eb = torch.exp(a - m), torch.exp(b - m)
    return ea / (ea + eb)
