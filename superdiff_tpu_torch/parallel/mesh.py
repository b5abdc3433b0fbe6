"""A mesh of named axes over ranks, and the batch and ensemble placement
helpers (port of ``superdiff_tpu/parallel/mesh.py``).

JAX's ``Mesh`` is an array of devices with named axes, and XLA inserts the
collectives that a sharding implies. PyTorch has no such compiler, so the
port's :class:`Mesh` is the same array of names over the ranks of the
``torch.distributed`` process group (one card, or one CPU process, a
rank), with a process group per axis, and every collective of
``parallel/`` is written out against those groups.

Axes, as in JAX:
  * ``data``: batch sharding (DP); gradients are all-reduced over it;
  * ``model``: the stacked-ensemble axis (each rank holds its own
    denoisers, ``models.ensemble.make_stacked_score_fn``);
  * ``dcn``: the leading process axis of the multi-host layout
    (``make_multihost_mesh``); DP then reduces over ``('dcn', 'data')``
    jointly.

Ranks fill the mesh in row-major order with the last axis innermost, as
JAX reshapes its device list: neighbouring ranks share a model group.

Building a mesh creates its process groups, which every rank of the world
must do together, in the same order. Without a process group the mesh is
one rank: every axis has size 1, there are no groups, and each collective
returns its input, so every single-process path runs as it did.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .distributed import TIMEOUT

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes over the world's ranks.

    ``shape`` maps each axis name to its size (JAX's ``mesh.shape``);
    ``devices`` holds the ranks in the mesh's shape (JAX's device array);
    ``coords`` this rank's index on each axis. :meth:`group` gives the
    process group of this rank's line along some axes, :meth:`all_reduce`
    and :meth:`all_gather` the collectives over it."""

    def __init__(self, axis_sizes: Sequence[Tuple[str, int]]):
        self.axis_names = tuple(name for name, _ in axis_sizes)
        sizes = tuple(int(s) for _, s in axis_sizes)
        self.shape: Mapping[str, int] = dict(zip(self.axis_names, sizes))
        self.distributed = dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh {dict(self.shape)} has {int(np.prod(sizes))} ranks; "
                             f"the world has {world}")
        self.rank = dist.get_rank() if self.distributed else 0
        self.devices = np.arange(world).reshape(sizes)
        where = np.argwhere(self.devices == self.rank)[0]
        self.coords = dict(zip(self.axis_names, (int(i) for i in where)))
        self._groups = {}
        if self.distributed:
            dp = tuple(a for a in self.axis_names if a in ("dcn", "data"))
            for axes in [(a,) for a in self.axis_names] + ([dp] if len(dp) > 1 else []):
                self._build_groups(axes)

    def _build_groups(self, axes: Tuple[str, ...]) -> None:
        """One group per line of the mesh along ``axes`` (all ranks create
        all of them, in the same order); keep this rank's."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        lines = np.transpose(self.devices, rest + idx).reshape(-1, self.size(axes))
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, timeout=TIMEOUT)
            if self.rank in ranks:
                self._groups[axes] = (g, ranks)

    def size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's position in its line along ``axes`` (row-major)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        """The process group of this rank's line along ``axes`` (None
        without a process group)."""
        axes = _axes(axes)
        return self._groups[axes][0] if self.distributed else None

    def ranks(self, axes: Axes) -> list[int]:
        """The global ranks of this rank's line along ``axes``, in order."""
        axes = _axes(axes)
        return list(self._groups[axes][1]) if self.distributed else [0]

    def all_reduce(self, x: torch.Tensor, axes: Axes, op=None) -> torch.Tensor:
        """Sum (or ``op``) of ``x`` over the line along ``axes``, in place;
        returns ``x``."""
        if self.distributed:
            dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=self.group(axes))
        return x

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """The line's tensors along ``axes``, concatenated on ``dim`` in
        line order (a new tensor)."""
        if not self.distributed:
            return x.clone()
        n = self.size(axes)
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=self.group(axes))
        return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank {self.rank})"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> Mesh:
    """A ('data', 'model') mesh over the world's ranks; ``data=None`` takes
    every rank the model axis leaves. ``devices`` must be None or the
    world's ranks (JAX picks a device subset; a rank outside every group
    has nothing to run)."""
    n = _world()
    if devices is not None and list(devices) != list(range(n)):
        raise ValueError(f"devices {list(devices)}: a port mesh spans the world's {n} ranks")
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    return Mesh((("data", data), ("model", model)))


def make_multihost_mesh(model: int = 1, devices=None) -> Mesh:
    """('dcn', 'data', 'model') mesh: the leading axis one per host (the
    ranks of a host contiguous, as ``torch.distributed``'s launchers number
    them), ``LOCAL_WORLD_SIZE`` ranks a host (the world when unset: one
    host)."""
    import os

    n = _world()
    if devices is not None and list(devices) != list(range(n)):
        raise ValueError(f"devices {list(devices)}: a port mesh spans the world's {n} ranks")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % local or local % model:
        raise ValueError(f"{n} ranks, {local} a host, not divisible by model={model}")
    return Mesh((("dcn", n // local), ("data", local // model), ("model", model)))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch axes of this mesh: ('dcn', 'data') when a DCN axis
    exists, else ('data',) (JAX's ``dp_spec``)."""
    return ("dcn", "data") if "dcn" in mesh.axis_names else ("data",)


def dp_spec(mesh: Mesh, *trailing) -> tuple:
    """JAX's batch-dim PartitionSpec as a tuple: the data axes for dim 0,
    then ``trailing``."""
    return (dp_axes(mesh),) + trailing


def data_sharding(mesh: Mesh) -> Tuple[int, int]:
    """(number of batch shards, this rank's shard): a (B, ...) batch is
    split contiguously over the data axes."""
    axes = dp_axes(mesh)
    return mesh.size(axes), mesh.index(axes)


def replicated(mesh: Mesh) -> tuple:
    """The trivial placement: every rank holds the whole array (JAX's
    ``P()``)."""
    return ()


def ensemble_sharding(mesh: Mesh, n_models: int) -> slice:
    """Which of the stacked ensemble's ``n_models`` models this rank holds:
    its slice of the leading model axis over ``'model'`` (``n_models //
    model`` each; JAX's spec ``P('model')``)."""
    m = mesh.shape.get("model", 1)
    if n_models % m:
        raise ValueError(f"{n_models} models not divisible by the model axis ({m})")
    per = n_models // m
    i = mesh.coords.get("model", 0)
    return slice(i * per, (i + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous slice of a host batch (a tensor, an array or
    a dict of them), the batch dim split over the data axes."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    n, i = data_sharding(mesh)
    b = batch.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by {n} data shards")
    return batch[i * (b // n):(i + 1) * (b // n)]


def local_mesh_for_testing(n: int = 8) -> Mesh:
    """A data mesh over the ranks that exist (at most ``n``: the world must
    not be larger)."""
    w = _world()
    if w > n:
        raise ValueError(f"the world has {w} ranks; a mesh of {n} leaves some out")
    return make_mesh(data=w, model=1)
