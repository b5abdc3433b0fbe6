"""Gated-weight download policy (a copy of ``superdiff_tpu/utils/hub.py``).

Every pretrained-weight loader tries the local HF cache / an explicit local
path first. The network fallback (the reference's default behavior — it
downloads from the hub on demand) is opt-in here: in a zero-egress image
each hub attempt costs ~a minute of HTTP retries before failing, so offline
runs must fail fast to the documented gated-skip path instead.
"""

from __future__ import annotations

import os


def allow_hub_download() -> bool:
    """True when the user explicitly allows fetching weights from the hub
    (SUPERDIFF_ALLOW_DOWNLOAD=1). Default: local caches only."""
    return os.environ.get("SUPERDIFF_ALLOW_DOWNLOAD", "") == "1"
