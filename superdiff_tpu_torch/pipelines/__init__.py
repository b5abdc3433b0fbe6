"""End-to-end pipelines."""

from . import sd

__all__ = ["sd"]
