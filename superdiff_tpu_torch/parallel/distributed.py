"""Multi-process initialisation and host-aware helpers (port of
``superdiff_tpu/parallel/distributed.py``).

JAX's ``jax.distributed.initialize`` becomes ``torch.distributed``'s
process group: NCCL between cards, gloo when the caller asks for the CPU.
The rendezvous is a TCP store at ``coordinator_address`` (``host:port``).
Every later collective of ``parallel/`` runs over groups built from this
one, so a rank that dies makes the others fail at the group's timeout
instead of hanging.

* ``initialize()`` is a no-op for a single-process run (both
  ``coordinator_address`` and ``num_processes`` None) and idempotent;
* ``is_coordinator()`` gates logging and checkpoint writes;
* ``host_shard_info()`` feeds the Kronecker time sampler's
  ``(num_shards, shard_index)`` (``core/dsm.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# a dead rank fails the run after this long instead of hanging it
TIMEOUT = datetime.timedelta(seconds=120)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> None:
    """Join the process group; safe to call in single-process runs.

    ``device`` names the backend: a CUDA device NCCL (each rank bound to
    ``cuda:{local_rank}``, ``LOCAL_RANK`` if set, else ``process_id``
    modulo the visible cards), the CPU gloo. A second call, once the group
    exists, does nothing."""
    if num_processes is None and coordinator_address is None:
        return  # single process: nothing to do
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize: give coordinator_address, num_processes and "
                         "process_id together")
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: NCCL needs a CUDA device, and none is visible "
                               "(device='cpu' joins over gloo)")
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw = {"backend": "nccl", "device_id": torch.device("cuda", local)}
    else:
        kw = {"backend": "gloo"}
    dist.init_process_group(init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT, **kw)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def host_shard_info() -> tuple[int, int]:
    """(num_shards, shard_index) for host-sharded sequences (Kronecker
    sampler parity with ``cifar/dynamics.py:9-13``): the world size and
    this rank, (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()
