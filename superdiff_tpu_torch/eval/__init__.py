"""Evaluation: FID / Inception Score statistics, bits per dimension, the
SD ODE likelihood, FLD, TIFA, the CLIP / ImageReward prompt metrics, the
cross-run aggregation and quality-table orderings, and the protein metrics
(structure metrics, self-consistency, novelty, the structure-embedding
map)."""

from . import (
    aggregate,
    bpd,
    clip_metrics,
    embed_viz,
    fid,
    fld,
    nll,
    novelty,
    ordering,
    self_consistency,
    struct_metrics,
    tifa,
)

__all__ = [
    "aggregate",
    "bpd",
    "clip_metrics",
    "embed_viz",
    "fid",
    "fld",
    "nll",
    "novelty",
    "ordering",
    "self_consistency",
    "struct_metrics",
    "tifa",
]
