"""Training: the state, the optimizer and DSM train step, checkpoints, and
the SE(3) DSM loss (``se3_trainer``)."""

from . import checkpoints, se3_trainer
from .state import TrainState
from .trainer import OptimizerSpec, init_train_state, make_optimizer, make_train_step

__all__ = ["OptimizerSpec", "TrainState", "checkpoints", "init_train_state",
           "make_optimizer", "make_train_step", "se3_trainer"]
