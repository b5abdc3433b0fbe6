#!/usr/bin/env python3
"""The attention kernels of two checkouts on one card: every mode of
``flash_attention_bhld.cu`` and the d-major ``flash_attention.cu``.

    python3 scripts/torch_attn_modes_ab.py --parent DIR [--rounds 3]

Loads ``DIR/superdiff_tpu_torch`` (another checkout, e.g. the parent commit
unpacked with ``git archive``) as a second package beside this checkout's,
builds both packages' attention libraries with ``nvcc`` (each into its own
``build/kernels``, all four sources at once) and launches both through their
own wrappers (``_launch``, ``_launch_bhld``, ``_launch_packed``), so each
side uses its own C interface, on the same inputs at the SD shapes: the
d-major rows of ``flash_mha_eod``, (B,H,L,D) views of one packed projection
for modes 0, 1 and 2 (as ``flash_eo`` hands them over), packed views for
``_kernel_mh_nat`` and the text cross-attention of ``_kernel_cross_packed``
(mode 3). Outputs are held to the parent's: bit for bit where
``BIT_EXACT`` names the kernel (same arithmetic), else within 1.2e-2 of the
parent's largest output (the kernel tolerance: another accumulation order,
or another kv tile for the running maximum, rounds p and the output to bf16
at other places); a failed hold is reported and the script goes on, then
exits 1. Each shape is timed in turns, parent, change, change, parent, per
round, by device time alone (``chip_smoke.graph_ms``: launches captured in
a CUDA graph and replayed) and, for the packed rows, by the wrapper's host
cost (``chip_smoke.host_ms``); one line per shape gives every time and the
medians, and the last line is a JSON object with the medians, the card's
name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIBS = ("flash_attention", "flash_attention_bhld")
# (label, TPU kernel, (B, H, Lq, D, Lk)): the shapes phase 2 of chip_smoke.py times
SHAPES = (
    ("eod", "_make_pvtd_kernel", (24, 8, 4096, 40, 4096)),
    ("eod", "_make_pvtd_kernel", (8, 8, 4096, 40, 4096)),
    ("eod", "_make_pvtd_kernel", (24, 8, 1024, 80, 1024)),
    ("eod", "_make_pvtd_kernel", (24, 8, 2304, 80, 2304)),
    ("eod", "_make_pvtd_kernel", (24, 8, 1024, 160, 1024)),
    ("bhld", "_kernel", (24, 8, 9216, 40, 9216)),
    ("bhld", "_kernel", (8, 8, 9216, 40, 9216)),
    ("bhld", "_kernel", (8, 8, 16384, 40, 16384)),
    ("bhld", "_kernel_1block", (24, 8, 4096, 40, 4096)),
    ("bhld", "_make_pvt_kernel", (24, 8, 4096, 40, 4096)),
    ("bhld", "_kernel_mh", (24, 8, 576, 160, 576)),
    ("bhld", "_kernel_mh", (24, 8, 1024, 80, 1024)),
    ("packed", "_kernel_mh_nat", (24, 8, 4096, 40, 4096)),
    ("packed", "_kernel_mh_nat", (24, 8, 4096, 40, 77)),
    ("packed", "_kernel_mh_nat", (24, 8, 1024, 80, 77)),
    ("packed", "_kernel_mh_nat", (24, 8, 256, 160, 77)),
    ("packed", "_kernel_cross_packed", (24, 8, 4096, 40, 77)),
    ("packed", "_kernel_cross_packed", (24, 8, 9216, 40, 77)),
)
# the kernels whose arithmetic this change keeps: every attention kernel (the
# Hopper primitives moved into the shared sm90_common.cuh, no device code
# changed)
BIT_EXACT = ("_make_pvtd_kernel", "_kernel", "_kernel_1block", "_make_pvt_kernel",
             "_kernel_mh", "_kernel_mh_nat", "_kernel_cross_packed")


def load_package(root: Path, alias: str):
    """``root/superdiff_tpu_torch`` imported as package ``alias``; returns
    its ``ops.flash_attention`` module (the package imports only relatively)."""
    spec = importlib.util.spec_from_file_location(
        alias, root / "superdiff_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(root / "superdiff_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.flash_attention")


def inputs(kind, b, h, lq, d, lk, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(lq + lk + d)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
    if kind == "eod":
        return rnd(b, h, d, lq), rnd(b, lk, h, d).permute(0, 2, 1, 3), rnd(b, h, d, lk)
    if lq == lk:
        qkv = rnd(b, lq, 3, h, d)
        views = [qkv[:, :, i] for i in range(3)]
    else:
        views = [rnd(b, lq, h, d), rnd(b, lk, h, d), rnd(b, lk, h, d)]
    if kind == "bhld":
        views = [a.permute(0, 2, 1, 3) for a in views]
    return views


def launcher(fa, kind, name, args, d):
    if kind == "eod":
        return lambda: fa._launch(*args, d ** -0.5)
    if kind == "bhld":
        return lambda: fa._launch_bhld(*args, d ** -0.5, name)
    return lambda: fa._launch_packed(*args, d ** -0.5, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_attn_modes_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, graph_ms, host_ms

    mods = {"parent": load_package(args.parent.resolve(), "parent_superdiff_tpu_torch"),
            "change": load_package(ROOT, "change_superdiff_tpu_torch")}
    builds = [threading.Thread(target=importlib.import_module(f"{m.__package__}._build").build_all,
                               args=(LIBS,)) for m in mods.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()

    card = card_line()
    print(f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    dev = torch.device("cuda", 0)
    summary, failed = {}, []
    for kind, name, (b, h, lq, d, lk) in SHAPES:
        data = inputs(kind, b, h, lq, d, lk, dev)
        runs = {tag: launcher(fa, kind, name, data, d) for tag, fa in mods.items()}
        outs = {tag: run() for tag, run in runs.items()}
        torch.cuda.synchronize()
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        mag = outs["parent"].float().abs().max().item()
        key = f"{name} {kind} {(b, h, lq, d, lk)}"
        same = torch.equal(outs["parent"], outs["change"])
        verdict = ("bit-identical" if same else
                   f"max diff {diff:.3e} ({diff / mag:.2e} of the largest output)")
        if not (same if name in BIT_EXACT else diff <= 1.2e-2 * mag):
            failed.append(key)
            verdict += " FAILS its hold"
        del outs
        times = {tag: [] for tag in runs}
        hosts = {tag: [] for tag in runs}
        for _ in range(args.rounds):
            for tag in ("parent", "change", "change", "parent"):
                times[tag].append(graph_ms(runs[tag]))
                if kind == "packed":
                    hosts[tag].append(host_ms(runs[tag]))
        med = {tag: statistics.median(ts) for tag, ts in times.items()}
        summary[key] = med
        line = (f"{key}: {verdict}; device ms parent " + ", ".join(f"{t:.4f}" for t in times["parent"])
                + "; change " + ", ".join(f"{t:.4f}" for t in times["change"])
                + f"; medians {med['parent']:.4f} / {med['change']:.4f} "
                f"({med['change'] / med['parent'] - 1:+.2%})")
        if kind == "packed":
            host = {tag: statistics.median(ts) for tag, ts in hosts.items()}
            summary[key] = {**med, "host_parent": host["parent"], "host_change": host["change"]}
            line += f"; host ms medians {host['parent']:.4f} / {host['change']:.4f}"
        print(line, flush=True)
        del data, runs
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "median_ms": summary, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
