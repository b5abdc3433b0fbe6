"""SuperDiff core: schedules, Itô density estimators, kappa policies and the
joint sampler."""

from . import ito, kappa, schedules, superpose

__all__ = ["ito", "kappa", "schedules", "superpose"]
