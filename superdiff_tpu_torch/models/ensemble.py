"""Model ensembles: N same-architecture denoisers behind one stacked oracle
(port of ``superdiff_tpu/models/ensemble.py``).

``make_stacked_score_fn`` turns N modules into ``score_fn(t, x) -> (N, B,
*event)``, the oracle ``core.superpose`` consumes; ``t`` and the labels are
shared by the N models. ``stack_params`` stacks the modules' parameters
along a new leading axis (``torch.func.stack_module_state``), the
counterpart of JAX's stacked pytree.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn


def stack_params(params_list: Sequence[nn.Module]):
    """``(params, buffers)``: each a dict of the N modules' tensors stacked
    along a new leading axis (copies)."""
    return torch.func.stack_module_state(list(params_list))


def unstack_params(stacked, n: int) -> list:
    """The N per-model slices of :func:`stack_params`' result (or of one
    dict of stacked tensors), as views."""
    if isinstance(stacked, tuple):
        return list(zip(*(unstack_params(s, n) for s in stacked)))
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def make_stacked_score_fn(
    models: Sequence[nn.Module],
    labels: Optional[torch.Tensor] = None,
    mode: str = "unroll",
    mesh=None,
) -> Callable[[object, torch.Tensor], torch.Tensor]:
    """Build ``score_fn(t, x) -> (N, B, *event)`` from N modules called as
    ``model(t_b, x, labels)`` with ``t_b`` the scalar ``t`` broadcast to
    (B, 1, ..., 1) in x's dtype. A 0-d tensor ``t`` on x's device is
    broadcast where it lies (no host round trip, so the step can be
    captured in a CUDA graph); a float or a CPU tensor is copied over
    first.

    mode:
      * ``"unroll"`` (default): N plain forwards, stacked;
      * ``"vmap"``: one shared body, ``torch.func.vmap`` over the modules'
        parameters stacked once, here (:func:`stack_params`), through
        ``torch.func.functional_call`` of the first module, as JAX vmaps
        one apply over its stacked tree. The modules must be in ``eval()``
        mode (dropout draws do not batch) and their later weight changes
        are not seen.

    ``mesh`` (a ``parallel.mesh.Mesh``) with a ``model`` axis of size m > 1:
    ensemble parallelism (JAX's ``ensemble_sharding``). This rank runs only
    its N / m models (``parallel.mesh.ensemble_sharding``), in ``mode``,
    and the per-model scores are all-gathered over ``model`` into the
    (N, B, ...) stack, so every rank holds all N. ``models`` lists all N;
    the others' are never called.
    """
    models = list(models)
    if mode not in ("unroll", "vmap"):
        raise ValueError(f"mode {mode!r}; one of 'unroll', 'vmap'")
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        from ..parallel.mesh import ensemble_sharding

        local = make_stacked_score_fn(models[ensemble_sharding(mesh, len(models))], labels, mode)

        def gathered(t, x):
            return mesh.all_gather(local(t, x), "model", dim=0)

        return gathered

    def t_b(t, x):
        return torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(
            (x.shape[0],) + (1,) * (x.ndim - 1))

    if mode == "vmap":
        params, buffers = stack_params(models)
        base = models[0]

        def single(p, b, tb, x):
            return torch.func.functional_call(base, (p, b), (tb, x, labels))

        batched = torch.func.vmap(single, in_dims=(0, 0, None, None))

        def score_fn(t, x):
            return batched(params, buffers, t_b(t, x), x)

        return score_fn

    def score_fn(t, x):
        tb = t_b(t, x)
        return torch.stack([m(tb, x, labels) for m in models], dim=0)

    return score_fn
