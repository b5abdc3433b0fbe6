"""Device-trace parsing: the kernel-family taxonomy of the port's profiles
(port of ``superdiff_tpu/utils/traceparse.py``, adapted to CUDA).

A torch.profiler Chrome trace (``utils.profiling.trace`` writes one) holds
one complete event (``"ph": "X"``) per kernel, memcpy and memset on the
device; :func:`load_device_ops` sums their durations by name and
:func:`categorize` buckets the names into kernel families (:func:`family`,
the one taxonomy ``chip_smoke.py`` reports every profile in). The port's
own kernels are families of their own: ``fused_sde_step``, the
online-softmax attention body (``_kernel``), the d-major two-pass body
(``flash_mha_eod``), the other bodies of the ``wgmma`` attention core, the
three launches of ``geglu_ffn_block``, ``sd_or_step`` and the two launches
of ``group_norm``; library work
falls into convolution, GEMM, softmax, reduction and the elementwise /
copy / cat glue.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from typing import Dict, Tuple

ONLINE = "attention, online (_kernel)"
EOD = "attention, d-major (flash_mha_eod)"
ATTN_OTHER = "attention, wgmma core, other"
FAMILIES = (("fused_sde_step", ("fused_sde_step",)),
            (ONLINE, ("attn_sm90_online",)),
            (EOD, (re.compile(r"attn_sm90_two_pass<\d+, true"),)),
            (ATTN_OTHER, ("attn_sm90",)),
            ("geglu_ffn_block", ("geglu_",)),
            ("sd_or_step", ("or_step",)),
            ("group_norm", ("group_norm_",)),
            ("convolution", ("conv", "fprop", "implicit", "cudnn", "nchw", "nhwc")),
            ("gemm", ("gemm", "cutlass", "cublas", "nvjet")),
            ("softmax", ("softmax",)),
            ("reduction", ("reduce",)),
            ("elementwise / copy / cat", ("elementwise", "vectorized", "copy", "cat",
                                           "unrolled", "index", "fill")))

# the device's own activity in a torch.profiler Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def family(key: str) -> str:
    """The family of a kernel named ``key`` in a profile."""
    key = key.lower()
    for fam, marks in FAMILIES:
        if any(m.search(key) if isinstance(m, re.Pattern) else m in key for m in marks):
            return fam
    return "other"


def category(name: str) -> str:
    """The category of a device op: its kernel family."""
    return family(name)


def _trace_files(path: str):
    if os.path.isfile(path):
        return [path]
    return sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
                  + glob.glob(os.path.join(path, "**", "*.json.gz"), recursive=True))


def load_device_ops(path: str) -> collections.Counter:
    """Sum the durations (us) of the device's complete events (kernels,
    memcpy, memset) per name, from a torch.profiler Chrome trace: a file,
    or the first ``*.json`` / ``*.json.gz`` under a directory."""
    files = _trace_files(path)
    assert files, f"no Chrome trace under {path}"
    opener = gzip.open if files[0].endswith(".gz") else open
    with opener(files[0], "rt") as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    per_op = collections.Counter()
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            per_op[ev.get("name", "")] += ev.get("dur", 0)
    return per_op


def categorize(per_op: collections.Counter) -> Tuple[collections.Counter, float]:
    """(family -> us, total us)."""
    cats = collections.Counter()
    for name, dur in per_op.items():
        cats[category(name)] += dur
    return cats, sum(per_op.values())


def report(per_op: collections.Counter, iters: int, top: int = 40) -> Dict:
    """Print the family / top-op report; return the families (ms per
    iteration) for BENCH_DETAIL."""
    cats, total = categorize(per_op)
    print(f"\ntotal device time: {total / 1e3 / iters:.3f} ms/iter over {iters} iters")
    print("\n== families (ms/iter) ==")
    for c, d in cats.most_common():
        print(f"  {c:36s} {d / 1e3 / iters:9.3f}")
    print(f"\n== top {top} ops (ms/iter) ==")
    for name, dur in per_op.most_common(top):
        print(f"  {dur / 1e3 / iters:9.3f}  {name[:110]}")
    return {
        "total_device_ms_per_iter": total / 1e3 / iters,
        "categories_ms_per_iter": {c: d / 1e3 / iters for c, d in cats.most_common()},
    }
