"""The traced run: spans the benchmark records around its calls into the
program, a ``torch.profiler`` session over the window, and the reading of
the session's device activity.

Spans are ``record_function`` ranges named ``bench.<phase>`` (``window``,
``inputs``, ``encode``, ``sample``, ``decode``); the drivers open and close
them, some from forward hooks on the program's modules. Each device
operation is put in the phase whose host range holds the launch it came
from (its correlation id; a CUDA graph's kernels share their replay's), or,
where the launch is not in the trace, in the phase whose device span holds
its start. Kernels are named by family with a frozen copy of the port's
kernel taxonomy (``superdiff_tpu_torch/utils/traceparse.py``), kept here
so that an edit to the port does not move the yardstick.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "bench."
GLUE = "elementwise / copy / cat"
FAMILIES = (("fused_sde_step", ("fused_sde_step",)),
            ("attention, online (_kernel)", ("attn_sm90_online",)),
            ("attention, d-major (flash_mha_eod)", (re.compile(r"attn_sm90_two_pass<\d+, true"),)),
            ("attention, wgmma core, other", ("attn_sm90",)),
            ("geglu_ffn_block", ("geglu_",)),
            ("sd_or_step", ("or_step",)),
            ("convolution", ("conv", "fprop", "implicit", "cudnn", "nchw", "nhwc")),
            ("gemm", ("gemm", "cutlass", "cublas", "nvjet")),
            ("softmax", ("softmax",)),
            ("reduction", ("reduce",)),
            (GLUE, ("elementwise", "vectorized", "copy", "cat", "unrolled", "index", "fill")))
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def family(name: str) -> str:
    key = name.lower()
    for fam, marks in FAMILIES:
        if any(m.search(key) if isinstance(m, re.Pattern) else m in key for m in marks):
            return fam
    return "other"


class Phases:
    """The current ``bench.<phase>`` span; :meth:`to` closes it and opens
    the next, :meth:`end` closes it."""

    def __init__(self):
        self._open = None

    def to(self, name: str) -> None:
        self.end()
        self._open = torch.autograd.profiler.record_function(PREFIX + name)
        self._open.__enter__()

    def end(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


@dataclasses.dataclass
class Reading:
    """What a traced window holds: device seconds by (phase, op name), the
    window's span (ns on the trace's clock), the device's busy seconds in
    it and its idle gaps, each with what the host was doing."""

    seconds: Dict[Tuple[Optional[str], str], float]
    window: Tuple[int, int]
    busy_s: float
    gaps: List[Tuple[str, float]]  # (what the host was doing, seconds), each gap

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def seconds_by(self, key, phase: Optional[str] = None) -> Dict[str, float]:
        out = collections.Counter()
        for (ph, name), sec in self.seconds.items():
            if phase is None or ph == phase:
                out[key(name)] += sec
        return dict(out)

    def family_seconds(self, phase: Optional[str] = None) -> Dict[str, float]:
        return self.seconds_by(family, phase)

    def matching_seconds(self, pattern: str, phase: Optional[str] = None) -> float:
        """Device seconds of the ops whose name matches ``pattern``
        (a case-insensitive regular expression)."""
        rx = re.compile(pattern, re.I)
        return sum(sec for (ph, name), sec in self.seconds.items()
                   if rx.search(name) and (phase is None or ph == phase))


class Session:
    """A profiler session over the host and the card whose events are read
    as kineto gives them, without building PyTorch's per-event objects (a
    window holds millions of kernels)."""

    def __init__(self):
        import torch.autograd.profiler as ap

        self._ap = ap
        self._prof = ap.profile(use_kineto=True, use_device="cuda" if torch.cuda.is_available()
                                else None)

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self):
        """The session's kineto results."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        results = self._ap._disable_profiler()
        self._ap._run_on_profiler_stop()
        return results


def _kind(e) -> str:
    """The event's kineto activity type, or where this PyTorch does not
    give it (2.11 does not), the nearest guess from its device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if name.startswith(PREFIX) else "kernel"
    if name.startswith(PREFIX):
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def read(results) -> Reading:
    """The device activity of a finished session (its kineto results)
    whose host ranges include one ``bench.window``."""
    spans, host, launches = [], [], {}
    names, start, dur, corr = [], [], [], []
    for e in results.events():
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            names.append(e.name())
            start.append(e.start_ns())
            dur.append(e.duration_ns())
            corr.append(e.correlation_id())
        elif kind == "user_annotation" and e.name().startswith(PREFIX):
            spans.append((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]))
        elif kind in ("cuda_runtime", "cuda_driver"):
            launches[e.correlation_id()] = e.start_ns()
            host.append((e.start_ns(), e.name()))
        elif kind in ("cpu_op", "user_annotation"):
            host.append((e.start_ns(), e.name()))
    windows = [(s, e) for s, e, n in spans if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} bench.window spans, not one")
    window = windows[0]
    phases = sorted((s, e, n) for s, e, n in spans if n != "window")
    p_start = np.array([p[0] for p in phases] or [0], dtype=np.int64)
    p_end = np.array([p[1] for p in phases] or [-1], dtype=np.int64)

    def span_at(t):
        """The index of the phase span that holds each host time t, or -1."""
        i = np.searchsorted(p_start, t, side="right") - 1
        return np.where((i >= 0) & (t <= p_end[np.maximum(i, 0)]), i, -1)

    start, dur = np.array(start, dtype=np.int64), np.array(dur, dtype=np.int64)
    inside = (start >= window[0]) & (start <= window[1])
    launch = np.array([launches.get(c, -1) for c in corr], dtype=np.int64)
    span = np.where(launch >= 0, span_at(launch), -1)
    # an op whose launch is not in the trace: the span whose device activity holds its start
    found = inside & (span >= 0)
    if (inside & (span < 0)).any() and found.any():
        lo = np.full(len(phases), np.iinfo(np.int64).max)
        hi = np.full(len(phases), np.iinfo(np.int64).min)
        np.minimum.at(lo, span[found], start[found])
        np.maximum.at(hi, span[found], (start + dur)[found])
        for k in np.nonzero(inside & (span < 0))[0]:
            hit = np.nonzero((lo <= start[k]) & (start[k] <= hi))[0]
            if len(hit):
                span[k] = hit[0]
    seconds = collections.Counter()
    for k in np.nonzero(inside)[0]:
        seconds[(phases[span[k]][2] if span[k] >= 0 else None, names[k])] += dur[k] / 1e9
    # busy time: the union of the ops' intervals, clipped to the window
    s = np.clip(start[inside], *window)
    e = np.clip((start + dur)[inside], *window)
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order]) if len(e) else e
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, len(s) - 1) if len(s) else first
    b_start, b_end = s[first], e[last]
    busy_ns = int((b_end - b_start).sum())
    # idle gaps: before each busy stretch, and after the last
    g_start = np.concatenate([[window[0]], b_end])
    g_end = np.concatenate([b_start, [window[1]]])
    host.sort()
    host_start = np.array([h[0] for h in host] or [0], dtype=np.int64)
    gaps = []
    for k in np.nonzero(g_end > g_start)[0]:
        t = int(g_start[k])
        i = int(np.searchsorted(host_start, t, side="right")) - 1
        doing = host[i][1] if i >= 0 and host else "nothing"
        j = int(span_at(np.array([t]))[0])
        gaps.append((f"{phases[j][2] if j >= 0 else 'between'}: {doing}",
                     (int(g_end[k]) - t) / 1e9))
    return Reading(seconds=dict(seconds), window=window, busy_s=busy_ns / 1e9, gaps=gaps)


def breakdown(reading: Reading, top: int = 10) -> dict:
    """The device ops that took most time and the idle time by what the
    host was doing, each ``[name, seconds]``, at most ``top`` of each."""
    per_op = collections.Counter(reading.seconds_by(lambda name: name))
    idle = collections.Counter()
    for what, sec in reading.gaps:
        idle[what] += sec
    return {"device_ops": [[n, s] for n, s in per_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}
