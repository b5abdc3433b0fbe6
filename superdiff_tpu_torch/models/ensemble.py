"""Model ensembles: N same-architecture denoisers behind one stacked oracle
(port of ``superdiff_tpu/models/ensemble.py``).

``make_stacked_score_fn`` turns N modules into ``score_fn(t, x) -> (N, B,
*event)``, the oracle ``core.superpose`` consumes; ``t`` and the labels are
shared by the N models.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn


def make_stacked_score_fn(
    models: Sequence[nn.Module],
    labels: Optional[torch.Tensor] = None,
) -> Callable[[object, torch.Tensor], torch.Tensor]:
    """Build ``score_fn(t, x) -> (N, B, *event)`` from N modules called as
    ``model(t_b, x, labels)`` with ``t_b`` the scalar ``t`` broadcast to
    (B, 1, ..., 1) in x's dtype: N plain forwards, stacked. A 0-d tensor
    ``t`` on x's device is broadcast where it lies (no host round trip, so
    the step can be captured in a CUDA graph); a float or a CPU tensor is
    copied over first."""
    models = list(models)

    def score_fn(t, x):
        tb = torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(
            (x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.stack([m(tb, x, labels) for m in models], dim=0)

    return score_fn
