"""Training state (port of ``superdiff_tpu/train/state.py``; parity with
``cifar/models/utils.py:30-39``).

The whole state is checkpointed: the step, the parameters (in the module)
and their EMA, Adam's moments and count, the learning-rate schedule, the
random generator's state and the Kronecker time-sampler cursor, so a
preempted run resumes where it stopped (``cifar/run_lib.py:49-52``).
``ema_rate`` is static, as in JAX: a restore keeps the template's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int  # the next update's number, 1 at the start
    model: nn.Module  # holds the parameters
    params_ema: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LRScheduler
    ema_rate: float = 0.9999
    generator: Optional[torch.Generator] = None  # eps and the dropout masks
    sampler_state: Optional[torch.Tensor] = None  # Kronecker cursor u0, fp32 0-d
    run_id: int = 0  # experiment-tracking resume id (reference: wandbid)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> dict:
        """Everything but ``ema_rate``, by reference (``torch.save`` it)."""
        return {
            "step": self.step,
            "params": self.model.state_dict(),
            "params_ema": dict(self.params_ema),
            "opt_state": self.optimizer.state_dict(),
            "schedule": self.schedule.state_dict(),
            "rng": self.generator.get_state(),
            "sampler_state": self.sampler_state,
            "run_id": self.run_id,
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> "TrainState":
        """Copy a :meth:`state_dict` (from any device) into this state's
        tensors, in place; returns self."""
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["params"], strict=True)
        if set(sd["params_ema"]) != set(self.params_ema):
            raise KeyError("params_ema: the checkpoint's names differ from the model's")
        for name, v in sd["params_ema"].items():
            self.params_ema[name].copy_(v)
        self.optimizer.load_state_dict(sd["opt_state"])
        self.schedule.load_state_dict(sd["schedule"])
        self.generator.set_state(sd["rng"].cpu())
        self.sampler_state.copy_(sd["sampler_state"])
        self.run_id = int(sd["run_id"])
        return self
