"""The DSM training step on one card (port of
``superdiff_tpu/train/trainer.py``).

The JAX step is one jitted function, its data parallelism a mesh with a
batch-sharded input; here it is an eager PyTorch step, and with a
``parallel.mesh.Mesh`` each rank runs it on its slice of the batch with
the gradients all-reduced by hand (``make_train_step``). The optimizer is optax's
``chain(clip(grad_clip), adam(linear warmup))`` rebuilt from
``torch.optim.Adam`` and a ``LambdaLR`` schedule:

* the clip is elementwise (``optax.clip`` = ``clip_grad_value_``, not a
  global-norm clip; ``cifar/train_utils.py:13-22``);
* the warmup counts updates from 0, as optax's schedule does: the first
  update has learning rate 0 (``LambdaLR`` with ``min(s / warmup, 1)``,
  stepped after each update), so the first step leaves the parameters
  unchanged while ``TrainState.step`` goes from 1 to 2. The rate equals
  optax's to float32 rounding (optax forms it as ``-lr (1 - s / warmup) +
  lr`` in float32);
* Adam with b1 0.9, b2 0.999, eps 1e-8, bias-corrected by the update count.

Parameters stay float32; a bf16 model casts them at each use, so the
gradients arrive in float32. No loss scaling and no autocast: JAX has
neither.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from .state import TrainState


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What the JAX package's ``make_optimizer`` returns: Adam with a linear
    warmup from 0 to ``lr`` over ``warmup`` updates, after an elementwise
    clip of the gradients to +-``grad_clip``. :meth:`init` builds the
    stateful PyTorch pair over given parameters."""

    lr: float = 2e-4
    warmup: int = 5_000
    beta1: float = 0.9
    eps: float = 1e-8
    grad_clip: float = 1.0

    def warmup_factor(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based) over ``lr``."""
        return 1.0 if self.warmup <= 0 else min(count / self.warmup, 1.0)

    def init(self, params):
        """(``torch.optim.Adam``, its ``LambdaLR`` warmup) over ``params``."""
        adam = torch.optim.Adam(params, lr=self.lr, betas=(self.beta1, 0.999), eps=self.eps)
        return adam, torch.optim.lr_scheduler.LambdaLR(adam, lambda c: self.warmup_factor(c))


def make_optimizer(
    lr: float = 2e-4,
    warmup: int = 5_000,
    beta1: float = 0.9,
    eps: float = 1e-8,
    grad_clip: float = 1.0,
) -> OptimizerSpec:
    """Adam + linear warmup + elementwise clip (``cifar/train_utils.py:13-22``)."""
    return OptimizerSpec(lr=lr, warmup=warmup, beta1=beta1, eps=eps, grad_clip=grad_clip)


def init_train_state(
    generator: torch.Generator,
    model: nn.Module,
    optimizer: OptimizerSpec,
    ema_rate: float = 0.9999,
    run_id: int = 0,
) -> TrainState:
    """Step 1, the EMA a copy of the parameters, fresh Adam moments, the
    cursor at 0.5 (fp32, on the model's device)."""
    adam, schedule = optimizer.init(model.parameters())
    dev = next(model.parameters()).device
    return TrainState(
        step=1,
        model=model,
        params_ema={n: p.detach().clone() for n, p in model.named_parameters()},
        optimizer=adam,
        schedule=schedule,
        ema_rate=ema_rate,
        generator=generator,
        sampler_state=torch.tensor(0.5, dtype=torch.float32, device=dev),
        run_id=run_id,
    )


def make_train_step(optimizer: OptimizerSpec, loss_fn: Callable, mesh=None,
                    donate: bool = False):
    """Build the DSM train step.

    ``loss_fn(sampler_state, batch, *, generator, eps) -> (loss,
    next_sampler_state)`` (``core.dsm.make_dsm_loss``, or
    ``se3_trainer.make_se3_dsm_loss`` for the protein score networks, whose
    sampler state passes through unchanged). Returns
    ``step_fn(state, batch, *, eps=None) -> (state, loss)``, which updates
    ``state`` in place (and returns it): loss and gradients with the model
    in ``train()`` mode, elementwise clip, Adam update, the schedule's next
    rate, EMA ``ema * rate + p * (1 - rate)``, ``step + 1``, the new cursor.
    ``eps`` (the loss's draws: for the image DSM loss unit normals of the
    batch's shape, for the SE(3) loss a dict) replaces the state
    generator's draw.

    ``mesh`` (a ``parallel.mesh.Mesh``): data parallelism. The state is
    replicated: every rank holds all of it. ``batch`` (and ``eps``) is the
    global batch, the same on every rank; each rank takes its
    ``shard_batch`` slice and the loss of its rows (build the loss with
    ``num_shards`` / ``shard_index`` of ``parallel.mesh.data_sharding``,
    so its times, noise and dropout masks are the global batch's). The
    gradients are flattened into one buffer and all-reduced (mean) over the
    data axes in one call before the elementwise clip, as JAX's jitted
    step clips the global gradient (a clip per rank first is another
    update); the returned loss is the global mean. Adam, the schedule and
    the EMA then run the same arithmetic on every rank, so the state stays
    equal bit for bit across ranks. A mesh without a process group (one
    rank) has nothing to reduce.

    ``donate``: JAX's buffer donation lets XLA update the state in place;
    this step always updates the state in place, so the flag is accepted
    and changes nothing.
    """
    del donate  # the state is always updated in place
    if mesh is not None:
        from ..parallel.mesh import dp_axes, shard_batch

    def step_fn(state: TrainState, batch, *, eps: Optional[torch.Tensor] = None):
        model = state.model
        model.train()
        named = list(model.named_parameters())
        params = [p for _, p in named]
        state.optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
            eps = None if eps is None else shard_batch(eps, mesh)
        loss, next_sampler_state = loss_fn(state.sampler_state, batch,
                                           generator=state.generator, eps=eps)
        loss.backward()
        if mesh is not None and mesh.distributed:
            loss = _mean_over(mesh, dp_axes(mesh),
                              [p.grad for p in params if p.grad is not None],
                              loss.detach())
        torch.nn.utils.clip_grad_value_(params, optimizer.grad_clip)
        state.optimizer.step()
        state.schedule.step()
        with torch.no_grad():
            ema = [state.params_ema[n] for n, _ in named]
            rate = state.ema_rate
            torch._foreach_mul_(ema, rate)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - rate))
            state.sampler_state = next_sampler_state.detach().clone()
        state.step += 1
        return state, loss.detach()

    return step_fn


@torch.no_grad()
def _mean_over(mesh, axes, grads, loss):
    """Mean of ``grads`` (in place) and of ``loss`` over the mesh's
    ``axes``: one all-reduce of the flattened gradients with the loss as
    their last element; returns the mean loss."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0].dtype)])
    mesh.all_reduce(flat, axes)
    flat /= mesh.size(axes)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
        flat[:-1].split([g.numel() for g in grads]), grads)])
    return flat[-1].to(loss.dtype)
