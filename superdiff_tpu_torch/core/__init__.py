"""SuperDiff core: sigma grids, Itô density estimators and kappa policies."""

from . import ito, kappa, schedules

__all__ = ["ito", "kappa", "schedules"]
