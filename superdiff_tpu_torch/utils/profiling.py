"""Profiling: torch.profiler traces, device-synced phase timing (port of
``superdiff_tpu/utils/profiling.py``), and the port's spans and counters.
Usage:

    with trace("/tmp/trace") as prof:  # a Chrome trace under the directory
        run(...)

    with phase_timer("sample") as t:   # wall time, the device synced
        out = run(...)

    with record() as rec:              # the spans and counters of the run
        run(...)
    torch.cuda.synchronize()           # before reading a span's device time
    [s.device_ms() for s in rec.spans if s.name == "step"]

The served paths open a :func:`span` at each layer boundary (``request``
around ``encode``, ``sample`` and ``decode``; ``sample`` around ``load``,
``capture`` and ``steps``; ``steps`` around each ``step``) and :func:`count`
what they did (``steps_replayed``, ``steps_eager``, ``graphs_captured``,
``loops_built``). Both record inside a :func:`record` block and whenever a
torch profiler session is open (``torch.autograd.profiler``'s
``_is_profiler_enabled``, which a session sets on start and clears on
stop); otherwise a span returns a shared no-op context and a count returns
at once. A span keeps its host times from ``time.time_ns``, the Unix clock
that a kineto trace stamps its host events with, and on the card two CUDA
events on the current stream, none inside a CUDA-graph capture. Nothing
here synchronises: :meth:`Span.device_ms` reads the events after the
caller's own sync. A span emits no profiler range, so it never shows in a
trace as device activity.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch
from torch.autograd import profiler as _profiler

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
    (queued launches count); logs to ``sink.log`` or prints. The phase is
    also a :func:`span` of its name."""
    _sync()
    with span(name):
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


# -- spans and counters --------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span. ``parent`` is the id of the span it opened in,
    ``request`` the id of the outermost open span (its own where it is the
    outermost), so every span of one request shares it. ``start_ns`` and
    ``end_ns`` are Unix time in ns (``end_ns`` None while open); ``counts``
    holds what :func:`count` added while it was the innermost open span."""

    name: str
    id: int
    parent: Optional[int]
    request: int
    start_ns: int
    end_ns: Optional[int] = None
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    events: Optional[list] = dataclasses.field(default=None, repr=False)  # CUDA events

    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> Optional[float]:
        """Milliseconds on the card from the span's start to its end (idle
        time included), once the card has passed its end: synchronise
        first. None where it holds no pair of events: no card in use, a
        capture under way at either end, or still open."""
        if self.events is None or len(self.events) != 2:
            return None
        return self.events[0].elapsed_time(self.events[1])


@dataclasses.dataclass
class Recording:
    """Spans in the order they opened, and the counters' totals."""

    spans: List[Span] = dataclasses.field(default_factory=list)
    totals: collections.Counter = dataclasses.field(default_factory=collections.Counter)


_blocks: List[Recording] = []  # the open record() blocks' recordings
_since_clear = Recording()
_ids = itertools.count(1)
_local = threading.local()  # .open: this thread's open spans, innermost last
_OFF = contextlib.nullcontext()


def _open_spans() -> List[Span]:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def _event() -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream, or None: no card in
    use, or a capture under way (an event there would join the graph)."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Live:
    """The context of a recorded span."""

    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        stack = _open_spans()
        outer = stack[-1] if stack else None
        sid = next(_ids)
        s = self.span = Span(self.name, sid, outer.id if outer else None,
                             outer.request if outer else sid, time.time_ns())
        ev = _event()
        if ev is not None:
            s.events = [ev]
        stack.append(s)
        for rec in (_since_clear, *_blocks):
            rec.spans.append(s)
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s.events is not None:
            ev = _event()
            s.events = None if ev is None else [s.events[0], ev]
        s.end_ns = time.time_ns()
        _open_spans().remove(s)  # the innermost, unless a step loop was left open
        return False


def span(name: str):
    """A context that records a :class:`Span` named ``name`` while
    recording is on, and a shared no-op context otherwise."""
    if not (_blocks or _profiler._is_profiler_enabled):
        return _OFF
    return _Live(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span and to
    the totals, while recording is on."""
    if not (_blocks or _profiler._is_profiler_enabled):
        return
    stack = _open_spans()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
    for rec in (_since_clear, *_blocks):
        rec.totals[name] += n


def steps(items: Iterable, counter: str) -> Iterable:
    """``items`` for a sampler's step loop: while recording, the loop in a
    ``steps`` span and each item in a ``step`` span of its own, each step
    counted under ``counter``; otherwise ``items`` itself."""
    if not (_blocks or _profiler._is_profiler_enabled):
        return items
    return _spanned_steps(items, counter)


def _spanned_steps(items: Iterable, counter: str):
    with span("steps"):
        for item in items:
            with span("step"):
                yield item
            count(counter)


@contextlib.contextmanager
def record():
    """The operator's switch: spans and counts recorded while the block is
    open; yields its :class:`Recording`."""
    rec = Recording()
    _blocks.append(rec)
    try:
        yield rec
    finally:
        _blocks.remove(rec)


def records() -> Recording:
    """Everything recorded since the last :func:`clear` (or the import);
    it grows until then."""
    return _since_clear


def clear() -> None:
    """Start :func:`records` afresh."""
    global _since_clear
    _since_clear = Recording()
