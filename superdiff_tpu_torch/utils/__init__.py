"""Metric logging, image grids, profiling (traces, phase timing, spans and
counters) and trace parsing."""

from . import images, profiling, traceparse
from .logging import MetricLogger

__all__ = ["MetricLogger", "images", "profiling", "traceparse"]
