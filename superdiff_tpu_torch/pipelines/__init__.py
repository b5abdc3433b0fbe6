"""End-to-end pipelines: the SD-1.x composition, the CIFAR experiment and
the SE(3) protein composition."""

from . import cifar, protein, sd

__all__ = ["cifar", "protein", "sd"]
