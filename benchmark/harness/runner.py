"""One run of one cell: set-up, a measured window of whole requests back to
back, then the check of what the window produced, and the result line.

``samples_per_s`` is every sample the window completed over the window's
time, from the start of its first request to the end of the first request
that finishes after ``--seconds`` (each request ends in a device sync on
its answers). ``setup_s`` runs from the process's start (``run.py``'s
first line) to the start of that first request. With ``--trace 1`` a
profiler session covers the whole requests of the window's first
``TRACE_SECONDS``, and the per-layer
metrics' readers take their numbers from that traced part: its trace, its
requests' sampler spans (CUDA events) and the window's memory counters.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

from benchmark.harness import compare, spec

TRACE_SECONDS = 10.0  # a traced run traces the whole requests of its window's first seconds
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "superdiff_tpu")
CACHE_ENV = {  # every build and kernel cache, at fixed paths inside the checkout
    "SUPERDIFF_TORCH_BUILD_DIR": ("build", "kernels"),
    "TORCH_EXTENSIONS_DIR": ("build", "torch_extensions"),
    "TRITON_CACHE_DIR": ("build", "triton"),
    "TORCHINDUCTOR_CACHE_DIR": ("build", "inductor"),
    "CUDA_CACHE_PATH": ("build", "cuda_cache"),
}


def set_environment(root: str) -> None:
    for var, parts in CACHE_ENV.items():
        os.environ[var] = os.path.join(root, *parts)
    os.environ["USE_FLAX"] = "0"  # keeps transformers, if loaded, from loading JAX


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


class Run:
    """What a per-layer metric's reader sees of one run."""

    def __init__(self, cell, driver, ref, reading, window_s, requests, peak_window_bytes,
                 kind):
        self.cell, self.driver, self.ref, self.reading = cell, driver, ref, reading
        self.window_s, self.requests = window_s, requests
        self.steps = requests * driver.steps
        self.samples = requests * driver.samples_per_request
        self.sampler_ms = list(driver.sampler_ms)[:requests]
        self.peak_window_bytes = peak_window_bytes
        self.kind = kind
        self._flops: Optional[int] = None

    def flops_per_request(self) -> int:
        if self._flops is None:
            self._flops = self.driver.model_flops(self.ref)
        return self._flops


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.find_cell(args.workload)
    set_environment(spec.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {power_limit()}", file=sys.stderr)
    result, lines = execute(cell, args, dev, t0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def execute(cell, args, dev, t0: float):
    """Set-up, the window, the check and the metrics of one run on ``dev``
    (the card; the CPU in the tests); returns (the result, the check's
    lines)."""
    import torch

    from benchmark.harness import tracing

    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ref = cell.reference()
    drv = cell.driver().Driver(cell, args.seed % (1 << 64), dev)
    drv.setup()
    marks = [("set-up", time.perf_counter())]
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = tracing.Session() if args.trace else None
    if prof is not None:
        prof.start()
    window = torch.autograd.profiler.record_function(tracing.PREFIX + "window")
    window.__enter__()
    start, start_unix = time.perf_counter(), time.time()
    requests = samples = 0
    results = traced = None  # the session's events; (requests, seconds) traced
    while True:
        samples += drv.request(requests)
        requests += 1
        now = time.perf_counter()
        if prof is not None and now - start >= min(TRACE_SECONDS, args.seconds):
            window.__exit__(None, None, None)
            results, traced, prof = prof.stop(), (requests, now - start), None
        if now - start >= args.seconds:
            break
    end = time.perf_counter()
    if not args.trace:
        window.__exit__(None, None, None)
    marks.append(("window", end))
    reading = None
    if results is not None:
        reading = tracing.read(results)
        del results
        marks.append(("trace read", time.perf_counter()))
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    window_s = end - start
    drv.release()
    limits = cell.traffic["limits"]
    numbers, failed = drv.check(limits=limits)
    ok, lines = compare.verdict(numbers, limits)
    marks.append(("check", time.perf_counter()))

    metrics = {}  # none from a CPU run: it has no device numbers
    if cuda and args.trace:
        run = Run(cell, drv, ref, reading, traced[1], traced[0], peak_window, kind)
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    elif cuda:
        measured = {"samples_per_s": samples / window_s, "setup_s": start - t0}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(max(setup_peak, peak_window))}
    result = {"correct": ok, "attempted": requests, "failed": failed, "metrics": metrics,
              "device": device}
    if reading is not None:
        device.update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = tracing.breakdown(reading)
    finite = lambda v: v if v is not None and math.isfinite(v) else None  # noqa: E731
    result["checks"] = {k: {"value": finite(numbers.get(k)), "limit": limits.get(k)}
                        for k in sorted(set(numbers) | set(limits))}
    marks.append(("metrics", time.perf_counter()))
    took = ", ".join(f"{name} {t - prev:.1f} s" for (name, t), (_, prev)
                     in zip(marks, [("start", t0)] + marks))
    lines[:0] = [f"window {window_s:.3f} s from unix time {start_unix:.3f}, {requests} "
                 f"requests, {samples} samples",
                 f"took: {took}",
                 "request s: " + " ".join(f"{t:.4f}" for t in drv.request_s),
                 "sampler ms: " + " ".join(f"{t:.2f}" for t in drv.sampler_ms)] + drv.notes
    return result, lines
