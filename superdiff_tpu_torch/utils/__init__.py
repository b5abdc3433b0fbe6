"""Metric logging, timing, image grids, profiling and trace parsing."""

from . import bench_io, images, profiling, traceparse
from .logging import MetricLogger, Timer

__all__ = ["MetricLogger", "Timer", "bench_io", "images", "profiling", "traceparse"]
