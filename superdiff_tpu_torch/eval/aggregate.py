"""Cross-run metric aggregation for the SD composition experiments (the
port's own copy of ``superdiff_tpu/eval/aggregate.py``, without pandas).

Rebuild of ``applications/images/parse_img_metric_files.py``: combine
per-(prompt-pair, seed, method) metric CSVs into the paper's comparison
table. Composition rules carried over:

* ``joint``      — best of the two prompt orderings (sd_ab vs sd_ba), the
  strongest single-prompt baseline (``parse_img_metric_files.py:139-155``).
* ``coin_flip``  — expected score of randomly picking one ordering.
* AND metric     — batch mean of the per-image MIN over the two prompts
  (faithful to both concepts).
* OR metric      — per-image MAX over prompts, and the |A-B| balance gap.

The JAX module reads the CSVs with pandas and returns DataFrames; the
card's machine has no pandas, so here the standard library's ``csv`` reads
them (a cell becomes an int, else a float, else stays a string, as
``pandas.read_csv`` types a column of such cells) and the functions return
plain lists and dicts with the same numbers: a table is a list of row
dicts, and ``summarize_methods`` returns ``{"methods": rows,
"joint_baseline": ...}`` where JAX keeps the baseline in ``attrs``.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, Iterable, List, Optional

import numpy as np

Rows = List[dict]


def _cell(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _column(rows: Rows, name: str) -> np.ndarray:
    return np.asarray([r[name] for r in rows], dtype=np.float64)


def load_metric_csvs(root: str, method: str) -> Rows:
    """Load ``metrics_{method}/metrics_{method}_{pair}.csv`` files written by
    the pipeline runner into one list of rows, each with a 'pair' key."""
    rows: Rows = []
    for path in sorted(glob.glob(os.path.join(root, f"metrics_{method}", "*.csv"))):
        pair = os.path.basename(path).rsplit(".", 1)[0]
        with open(path, newline="") as fh:
            for rec in csv.DictReader(fh):
                rows.append({**{k: _cell(v) for k, v in rec.items()}, "pair": pair})
    return rows


def and_scores(rows: Rows, prefix: str = "clip") -> Dict[str, float]:
    """AND operator metric: mean over images of min(score_A, score_B)."""
    a, b = _column(rows, f"{prefix}_raw_score_1"), _column(rows, f"{prefix}_raw_score_2")
    return {
        "min_mean": float(np.minimum(a, b).mean()),
        "avg_mean": float(((a + b) / 2).mean()),
    }


def or_scores(rows: Rows, prefix: str = "clip") -> Dict[str, float]:
    """OR operator metrics: per-image max and the balance gap |A - B|."""
    a, b = _column(rows, f"{prefix}_raw_score_1"), _column(rows, f"{prefix}_raw_score_2")
    return {
        "max_mean": float(np.maximum(a, b).mean()),
        "gap_mean": float(np.abs(a - b).mean()),
    }


def joint_baseline(rows_ab: Rows, rows_ba: Rows, column: str = "min_clip") -> Dict[str, float]:
    """Best-of-orderings and coin-flip baselines over aligned rows."""
    ab, ba = _column(rows_ab, column), _column(rows_ba, column)
    n = min(len(ab), len(ba))
    ab, ba = ab[:n], ba[:n]
    return {
        "joint": float(np.maximum(ab, ba).mean()),
        "coin_flip": float(((ab + ba) / 2).mean()),
        "sd_ab": float(ab.mean()),
        "sd_ba": float(ba.mean()),
    }


def summarize_methods(root: str, methods: Iterable[str], prefix: str = "clip") -> dict:
    """One row per method with AND/OR aggregates (``"methods"``); the
    joint / coin-flip baseline (``"joint_baseline"``) when both orderings
    are present, else None."""
    cache = {m: load_metric_csvs(root, m) for m in methods}
    rows = [{"method": m, **and_scores(r, prefix), **or_scores(r, prefix)}
            for m, r in cache.items() if r]
    ab, ba = cache.get("sd_ab"), cache.get("sd_ba")
    jb: Optional[dict] = (joint_baseline(ab, ba, column=f"min_{prefix}")
                          if ab and ba else None)
    return {"methods": rows, "joint_baseline": jb}
