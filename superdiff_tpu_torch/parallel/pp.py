"""Pipeline parallelism (GPipe fill-drain) over a mesh axis (port of
``superdiff_tpu/parallel/pp.py``).

A stack of N stages of one signature runs one stage a rank over the
``pp`` axis; microbatches stream through the chain, one hop a tick:
at tick ``t`` rank 0 ingests microbatch ``t``, every rank applies its
stage, rank N-1 keeps its result for slot ``t - (N-1)``, and the
activation moves to the next rank. ``M`` microbatches complete in
``M + N - 1`` ticks (bubble ``(N-1)/(M+N-1)``; pick ``n_micro >= 4*N``).
JAX computes every stage at every tick and gates the emission; here a
rank computes, sends and receives only at the ticks where it holds a real
microbatch (the same ``n_micro`` results a stage, the same hops), which
is what the gated garbage ticks amount to. The last stage's outputs are
replicated by a sum all-reduce over the axis (JAX's ``psum``; the other
ranks contribute zeros).

**Gradients.** The pipeline is reverse-differentiable and its gradients
equal the sequential stack's. The schedule is one
``torch.autograd.Function``: its forward keeps each tick's local graph
(the stage applied to a detached input), its backward runs the ticks in
reverse, receiving the output's gradient from the next rank, taking the
stage's vector-Jacobian product and sending the input's gradient back one
hop. The backward is one Function and not a shift node a tick because
NCCL matches point-to-point messages between two ranks in the order they
are posted, and the autograd engine's order among ready nodes is no
contract: the explicit reverse schedule posts them in one fixed order on
every rank. The output's all-reduce is a sum of the last stage's values,
so its backward hands the output's gradient to the last stage unchanged;
the input's gradient, formed on rank 0, is summed over the axis so every
rank holds it (JAX's cotangent of a replicated input).

Constraints, as in JAX: every stage is ``stage_fn(params_i, x) -> y`` with
``y.shape == x.shape`` and couples no samples within a microbatch.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def _leaves(params):
    """The tensors of a stage's parameters (a tensor, a dict or list of
    them, or a module), in a fixed order."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _leaves(params[k])]
    return [t for p in params for t in _leaves(p)]


def _stage(stage_params, i: int):
    """Stage ``i``'s parameters: entry ``i`` of a sequence, or row ``i`` of
    every leaf of a stacked dict."""
    if isinstance(stage_params, dict):
        return {k: _stage(v, i) if isinstance(v, dict) else v[i]
                for k, v in stage_params.items()}
    return stage_params[i]


class _Schedule(torch.autograd.Function):
    """The fill-drain schedule on this rank; see the module docstring."""

    @staticmethod
    def forward(ctx, run, inputs, *leaves):
        stage_fn, params_i, mesh, axis_name = run
        n, idx = mesh.shape[axis_name], mesh.coords[axis_name]
        ranks, group = mesh.ranks(axis_name), mesh.group(axis_name)
        n_micro = inputs.shape[0]
        outputs = torch.zeros_like(inputs)
        ticks = []  # (tick, local input, local output) where this rank holds a microbatch
        for t in range(n_micro + n - 1):
            mb = t - idx
            if not 0 <= mb < n_micro:
                continue
            if idx == 0:
                x = inputs[mb]
            else:
                x = torch.empty_like(inputs[0])
                dist.recv(x, ranks[idx - 1], group=group)
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(params_i, x)
            if idx == n - 1:
                outputs[mb] = y.detach()
            else:
                dist.send(y.detach().contiguous(), ranks[idx + 1], group=group)
            ticks.append((mb, x, y))
        ctx.run, ctx.ticks, ctx.leaves = run, ticks, leaves
        ctx.input_shape = inputs.shape
        return mesh.all_reduce(outputs, axis_name)

    @staticmethod
    def backward(ctx, g_out):
        _, _, mesh, axis_name = ctx.run
        n, idx = mesh.shape[axis_name], mesh.coords[axis_name]
        ranks, group = mesh.ranks(axis_name), mesh.group(axis_name)
        leaves = [p for p in ctx.leaves if p.requires_grad]
        g_leaves = [torch.zeros_like(p) for p in leaves]
        g_in = torch.zeros(ctx.input_shape, dtype=g_out.dtype, device=g_out.device)
        for mb, x, y in reversed(ctx.ticks):
            if idx == n - 1:
                g_y = g_out[mb].contiguous()
            else:
                g_y = torch.empty_like(y)
                dist.recv(g_y, ranks[idx + 1], group=group)
            grads = torch.autograd.grad(y, [x] + leaves, g_y, allow_unused=True)
            for acc, g in zip(g_leaves, grads[1:]):
                if g is not None:
                    acc += g
            if idx == 0:
                g_in[mb] = grads[0]
            else:
                dist.send(grads[0].contiguous(), ranks[idx - 1], group=group)
        ctx.ticks = None
        mesh.all_reduce(g_in, axis_name)
        it = iter(g_leaves)
        return (None, g_in) + tuple(next(it) if p.requires_grad else None for p in ctx.leaves)


def pipeline_local(
    stage_params,
    inputs: torch.Tensor,
    *,
    stage_fn: Callable,
    mesh: Mesh,
    axis_name: str,
) -> torch.Tensor:
    """Pipeline body on this rank.

    Args:
      stage_params: this rank's stage parameters (a module, a tensor, or a
        dict or list of them), handed to ``stage_fn`` as they are.
      inputs: ``(n_micro, mb, ...)`` microbatched activations, the same on
        every rank (rank 0 is the only reader).
      stage_fn: ``(params_i, x) -> y`` with ``y.shape == x.shape``.
      mesh, axis_name: the axis the stages are spread over.

    Returns ``(n_micro, mb, ...)`` outputs, identical on every rank.
    """
    return _Schedule.apply((stage_fn, stage_params, mesh, axis_name), inputs,
                           *_leaves(stage_params))


def pipeline(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "pp",
    n_micro: Optional[int] = None,
) -> torch.Tensor:
    """Run ``x`` through the stage stack, pipelined over ``mesh[axis_name]``.

    Args:
      stage_fn: ``(params_i, x) -> y``, ``y.shape == x.shape``, applied
        per stage; must not couple samples within a microbatch.
      stage_params: every stage's parameters, ``n_stages ==
        mesh.shape[axis_name]`` of them: a dict (nested or not) of tensors
        whose every leaf has leading axis ``n_stages`` (JAX's stacked
        pytree), or a sequence with one entry a stage (modules, say). This
        rank runs stage ``mesh.coords[axis_name]``.
      x: ``(batch, ...)`` activations, the same on every rank.
      n_micro: microbatch count (must divide batch); defaults to
        ``4 * n_stages`` capped at ``batch`` (the largest divisor of batch
        not above it), with a warning when that leaves a bubble above 20 %.

    Returns ``(batch, ...)`` on every rank, equal to applying the stages
    in turn within fp32 reassociation (each stage sees the same rows, so
    the two agree to the stage's own batch-size dependence).
    """
    n = mesh.shape[axis_name]
    if isinstance(stage_params, dict):
        sizes = {leaf.shape[0] for leaf in _leaves(stage_params)}
    else:
        sizes = {len(stage_params)}
    if sizes != {n}:
        raise ValueError(f"stage_params leading axes {sizes} != mesh axis "
                         f"'{axis_name}' size {n}")
    batch = x.shape[0]
    if n_micro is None:
        n_micro = min(4 * n, batch)
        while batch % n_micro:
            n_micro -= 1
        bubble = (n - 1) / (n_micro + n - 1)
        if bubble > 0.2:
            warnings.warn(
                f"pipeline: default n_micro={n_micro} for batch={batch} over "
                f"{n} stages gives a {bubble:.0%} bubble (> the documented "
                "20% target); pass n_micro explicitly or pad the batch to a "
                f"multiple of {4 * n}",
                stacklevel=2,
            )
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro {n_micro}")
    xm = x.reshape((n_micro, batch // n_micro) + tuple(x.shape[1:]))
    out = pipeline_local(_stage(stage_params, mesh.coords[axis_name]), xm, stage_fn=stage_fn,
                         mesh=mesh, axis_name=axis_name)
    return out.reshape(x.shape)
