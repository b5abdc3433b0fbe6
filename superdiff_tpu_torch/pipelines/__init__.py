"""End-to-end pipelines: the SD-1.x composition and the CIFAR joint sampler."""

from . import cifar, sd

__all__ = ["cifar", "sd"]
