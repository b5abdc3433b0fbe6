"""Training: the state, the optimizer and DSM train step, checkpoints."""

from . import checkpoints
from .state import TrainState
from .trainer import OptimizerSpec, init_train_state, make_optimizer, make_train_step

__all__ = ["OptimizerSpec", "TrainState", "checkpoints", "init_train_state",
           "make_optimizer", "make_train_step"]
