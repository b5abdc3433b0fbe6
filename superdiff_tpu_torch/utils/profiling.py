"""Profiling: torch.profiler traces and device-synced phase timing (port of
``superdiff_tpu/utils/profiling.py``). Usage:

    with trace("/tmp/trace") as prof:  # a Chrome trace under the directory
        run(...)

    with phase_timer("sample") as t:   # wall time, the device synced
        out = run(...)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.pt.trace.json"


@contextlib.contextmanager
def trace(logdir: str, *, host: bool = True):
    """A torch.profiler session over the host and, where there is one, the
    card; on exit it writes ``logdir/trace.pt.trace.json`` (Chrome trace
    format, which ``utils.traceparse.load_device_ops`` reads). Yields the
    profiler, whose ``key_averages()`` hold the same session.
    ``host=False`` records the card's activity alone, where there is a
    card: a far smaller and quicker trace of a host-heavy step."""
    from torch.profiler import ProfilerActivity, profile

    activities = []
    if host or not torch.cuda.is_available():
        activities.append(ProfilerActivity.CPU)
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _PhaseTimer:
    def __init__(self, name: str, sink=None):
        self.name = name
        self.sink = sink
        self.t0 = time.perf_counter()
        self.elapsed: Optional[float] = None

    def sync(self, result):
        """Wait for the device's queued work; returns ``result``."""
        _sync()
        return result


@contextlib.contextmanager
def phase_timer(name: str, sink=None):
    """Time a phase on the host clock, the device synchronized at its end
    (queued launches count); logs to ``sink.log`` or prints."""
    _sync()
    t = _PhaseTimer(name, sink)
    try:
        yield t
    finally:
        _sync()
        t.elapsed = time.perf_counter() - t.t0
        msg = {"phase": name, "seconds": t.elapsed}
        if sink is not None:
            sink.log(**msg)
        else:
            print(f"[profile] {name}: {t.elapsed:.3f}s", flush=True)


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every card, keyed ``cuda:<i>``; empty
    without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
