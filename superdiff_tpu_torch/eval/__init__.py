"""Evaluation: FID / Inception Score statistics, bits per dimension, the
CLIP / ImageReward prompt metrics and the protein metrics (structure
metrics, self-consistency, novelty, the structure-embedding map)."""

from . import bpd, clip_metrics, embed_viz, fid, novelty, self_consistency, struct_metrics

__all__ = ["bpd", "clip_metrics", "embed_viz", "fid", "novelty", "self_consistency",
           "struct_metrics"]
