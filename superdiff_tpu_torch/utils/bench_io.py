"""Shared BENCH_DETAIL.json persistence for measurement scripts (the port's
own copy of ``superdiff_tpu/utils/bench_io.py``): each script merges its
keyed entries into one artifact at the repository's root."""

from __future__ import annotations

import json
import os
from typing import Dict

DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "BENCH_DETAIL.json")


def merge_bench_detail(entries: Dict[str, dict], path: str = DEFAULT_PATH) -> str:
    """Merge ``entries`` into the artifact, keeping keys owned by other
    scripts (merge, don't overwrite). Returns the path written.

    The write is atomic (temp file + ``os.replace``): a kill mid-dump must
    not leave a truncated artifact that the next merge would reset to
    ``{}``."""
    merged: Dict[str, dict] = {}
    if os.path.exists(path):
        try:
            with open(path) as fh:
                merged = json.load(fh)
        except (OSError, ValueError):
            merged = {}
    merged.update(entries)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(merged, fh, indent=2)
    os.replace(tmp, path)
    return os.path.abspath(path)
