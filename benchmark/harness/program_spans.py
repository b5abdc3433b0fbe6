"""The program's own spans and counters, as the readers of ``program_span``
and ``program_counter`` metrics take them: what
``superdiff_tpu_torch.utils.profiling`` recorded since its last clear. The
program records whenever a torch profiler session is open, and nothing else
turns its recording on in a run, so that is the traced window's requests.
The harness imports nothing of the program: the recorder is read where the
program's own imports loaded it, and a program without one gives nothing
(each reader is then silent).

A span's device time runs between two CUDA events on the stream the
program launched on, idle time included; :meth:`tracing.Session.stop`
synchronises before any reader runs."""

from __future__ import annotations

import sys
from typing import Optional

RECORDER = "superdiff_tpu_torch.utils.profiling"


def recording():
    """The program's recording (``spans``, ``totals``), or None where the
    program has no recorder."""
    records = getattr(sys.modules.get(RECORDER), "records", None)
    return records() if records is not None else None


def ms_per_request(name: str) -> Optional[float]:
    """The device ms of the spans named ``name`` summed, over the recorded
    ``request`` spans; None where no such span holds a device time."""
    rec = recording()
    if rec is None:
        return None
    ms = [s.device_ms() for s in rec.spans if s.name == name]
    ms = [m for m in ms if m is not None]
    requests = sum(s.name == "request" for s in rec.spans)
    return sum(ms) / requests if ms and requests else None
