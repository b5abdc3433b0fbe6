"""Metric logging, timing and image grids."""

from . import images
from .logging import MetricLogger, Timer

__all__ = ["MetricLogger", "Timer", "images"]
