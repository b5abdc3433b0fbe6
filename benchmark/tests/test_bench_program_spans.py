"""The readers of the program's own spans and counters
(``steps_ms_per_step``, ``encode_ms_per_request``, ``decode_ms_per_request``,
``captured_step_share``): their values on a recording of known device times
and counts, silence where the program has no recorder or no such span, and
what they read from the tiny cells' drivers with a host clock standing in
for the card's events."""

import collections
import sys
import time
import types

import pytest

import superdiff_tpu_torch.utils.profiling as profiling
from benchmark.harness import program_spans
from benchmark.tests.tiny import tiny_cell

SD, CIFAR = "sd-v1-4.or.512.b1", "cifar10-pair.or_sde.b100"
SEED = 2**31 + 7
READERS = ("steps_ms_per_step", "encode_ms_per_request", "decode_ms_per_request",
           "captured_step_share")


class _At:
    """An event at a fixed time in ms: ``elapsed_time`` as a CUDA event's."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


class _Now(_At):
    """An event at the host clock's time: the CPU's stand-in for the card's."""

    def __init__(self):
        super().__init__(1e3 * time.perf_counter())


def _span(name, sid, request, ms=None, **counts):
    s = profiling.Span(name, sid, None if sid == request else request, request, 0, 1,
                       counts=dict(counts))
    if ms is not None:
        s.events = [_At(100.0), _At(100.0 + ms)]
    return s


def _read(name):
    return tiny_cell(SD).reader(name).read(None)


def _recording(spans, **totals):
    return profiling.Recording(spans=spans, totals=collections.Counter(totals))


def test_readers_on_a_known_recording(monkeypatch):
    spans = [_span("request", 1, 1), _span("encode", 2, 1, 30.0), _span("sample", 3, 1),
             _span("load", 4, 1, 0.5), _span("capture", 5, 1, 400.0, graphs_captured=1),
             _span("steps", 6, 1, 98.0 * 49, steps_replayed=49), _span("decode", 7, 1, 60.0),
             _span("request", 8, 8), _span("encode", 9, 8, 20.0), _span("sample", 10, 8),
             _span("steps", 11, 8, 100.0 * 50, steps_eager=50), _span("decode", 12, 8, 70.0)]
    rec = _recording(spans, steps_replayed=49, steps_eager=50, graphs_captured=1)
    monkeypatch.setitem(sys.modules, program_spans.RECORDER,
                        types.SimpleNamespace(records=lambda: rec))
    assert _read("steps_ms_per_step") == pytest.approx((98.0 * 49 + 100.0 * 50) / 99)
    assert _read("encode_ms_per_request") == pytest.approx(25.0)
    assert _read("decode_ms_per_request") == pytest.approx(65.0)
    assert _read("captured_step_share") == pytest.approx(100.0 * 49 / 99)
    rec.spans = [s for s in spans if s.name not in ("encode", "decode")]
    assert _read("encode_ms_per_request") is None and _read("decode_ms_per_request") is None
    rec.spans, rec.totals = [], collections.Counter()
    assert all(_read(m) is None for m in READERS)


@pytest.mark.parametrize("module", [None, types.SimpleNamespace()], ids=["absent", "older"])
def test_readers_are_silent_without_the_program_recorder(monkeypatch, module):
    """The parent of the change that added the recorder, or no program
    loaded: every reader returns None and none raises."""
    if module is None:
        monkeypatch.delitem(sys.modules, program_spans.RECORDER)
    else:
        monkeypatch.setitem(sys.modules, program_spans.RECORDER, module)
    assert all(_read(m) is None for m in READERS)


@pytest.mark.parametrize("name", [SD, CIFAR])
def test_readers_on_the_tiny_drivers(monkeypatch, name):
    """Two requests after the warm-up, recorded, with the host clock in the
    events' place: the spans account for no more than each request took,
    and the CPU's eager steps read 0 % captured."""
    monkeypatch.setattr(profiling, "_event", _Now)
    cell = tiny_cell(name)
    drv = cell.driver().Driver(cell, SEED, "cpu")
    drv.setup()
    profiling.clear()
    with profiling.record():
        for i in range(2):
            drv.request(i)
    read = {m: cell.reader(m).read(None) for m in READERS}
    profiling.clear()
    assert read["captured_step_share"] == 0.0
    assert read["steps_ms_per_step"] > 0
    per_request = read["steps_ms_per_step"] * drv.steps
    if name == SD:
        assert read["encode_ms_per_request"] > 0 and read["decode_ms_per_request"] > 0
        per_request += read["encode_ms_per_request"] + read["decode_ms_per_request"]
    else:
        assert read["encode_ms_per_request"] is None and read["decode_ms_per_request"] is None
    assert per_request < 1e3 * sum(drv.request_s) / 2
