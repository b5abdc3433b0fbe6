"""Checkpointing with preemption-safe restore (port of
``superdiff_tpu/train/checkpoints.py``; parity with ``cifar/run_lib.py:43-52``).

Orbax becomes ``torch.save`` of the whole ``TrainState.state_dict()``
(parameters, EMA, Adam state, schedule, generator state, cursor) under the
JAX manager's rules: a ``checkpoints/`` directory in the run's workdir,
``chkpt_<id>`` names with the step as id, at most ``max_to_keep`` (50)
kept, the latest restored on start-up. Each file is written to a temporary
name and moved into place with ``os.replace``, so a run cut during a save
leaves the previous checkpoint as the latest.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .state import TrainState

_NAME = re.compile(r"^chkpt_(\d+)\.pt$")


class CheckpointManager:
    """The checkpoints of one run: ``<directory>/chkpt_<step>.pt``."""

    def __init__(self, directory: str, max_to_keep: int = 50):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"chkpt_{step}.pt")

    def all_steps(self) -> list[int]:
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def make_manager(workdir: str, max_to_keep: int = 50) -> CheckpointManager:
    return CheckpointManager(os.path.abspath(os.path.join(workdir, "checkpoints")),
                             max_to_keep)


def save(mgr: CheckpointManager, step: int, state: TrainState) -> None:
    """Write ``state`` as checkpoint ``step`` (atomically), then drop the
    oldest beyond ``max_to_keep``."""
    final = mgr.path(step)
    tmp = f"{final}.tmp{os.getpid()}"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, final)
    for old in mgr.all_steps()[:-mgr.max_to_keep]:
        os.remove(mgr.path(old))


def restore_latest(mgr: CheckpointManager, template: TrainState) -> Optional[TrainState]:
    """Load the latest checkpoint into ``template`` (in place, onto its
    devices) and return it; None when there is none (a fresh run)."""
    step = mgr.latest_step()
    if step is None:
        return None
    sd = torch.load(mgr.path(step), map_location="cpu", weights_only=True)
    return template.load_state_dict(sd)
