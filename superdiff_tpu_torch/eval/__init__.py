"""Evaluation: FID / Inception Score statistics and bits per dimension."""

from . import bpd, fid

__all__ = ["bpd", "fid"]
