#!/usr/bin/env python3
"""The step epilogues ``sd_or_step`` and ``fused_sde_step`` of two checkouts
on one card, in turns.

    python3 scripts/torch_step_kernels_ab.py --parent DIR [--rounds 3]

Loads ``DIR/superdiff_tpu_torch`` (another checkout, e.g. the parent commit
unpacked with ``git archive``) as a second package beside this checkout's,
builds both packages' ``sd_fused_step`` and ``fused_step`` libraries with
``nvcc`` at once and calls each through its own wrapper on the same inputs:
``sd_or_step`` at (3, 4100) and the 512, 768 and 1024 px rows (8, 16384),
(8, 36864), (8, 65536); ``fused_sde_step`` at (3, 10, 384), (2, 16, 256)
and the CIFAR main path's (2, 100, 3072), with and without ties in logq.
A wrapper that takes its step scalars from device memory gets them as 0-d
CUDA tensors, one that takes host floats gets floats (the values are the
same). The change is held to the parent at ``chip_smoke.py`` phase 2's
tolerances (x within 1e-5 of its largest value; ll / logq within 1e-5 of
the increments and 1e-4 of the values); a failed hold is reported, the
script goes on and then exits 1.

Each shape is timed in turns, parent, change, change, parent, per round, by
device time alone (``chip_smoke.graph_ms``: 20 calls captured in a CUDA
graph and replayed), beside the device time of an empty kernel in the same
kind of graph (``chip_smoke.empty_launch`` on the change's grid of
clusters: the floor of one launch) and the bytes' bound.
One line per shape gives every time and the medians; the last line is a
JSON object with the medians, the card's name and power limit. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import itertools
import json
import statistics
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OR_SHAPES = ((3, 4100), (8, 16384), (8, 36864), (8, 65536))
SDE_SHAPES = ((3, 10, 384), (2, 16, 256), (2, 100, 3072))
SIGMA, DSIGMA = 14.6146, -0.3279


def load_package(root: Path, alias: str):
    """``root/superdiff_tpu_torch`` imported as package ``alias`` (the
    package imports only relatively); returns it."""
    spec = importlib.util.spec_from_file_location(
        alias, root / "superdiff_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(root / "superdiff_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def reads_device_scalars(pkg) -> bool:
    """Whether this checkout's step kernels read their step scalars from
    device memory (its ``_build`` puts host values on the card for them)."""
    return hasattr(importlib.import_module(f"{pkg.__name__}.ops._build"), "device_scalars")


def scalars(values, on_device: bool, dev):
    import torch

    if not on_device:
        return [float(v) for v in values]
    return list(torch.tensor([float(v) for v in values], device=dev).unbind())


def or_cases(mods, dev):
    """(shape, {tag: run}, hold, bytes, rows) per ``sd_or_step`` shape, made
    as the caller reaches it."""
    import torch

    for b, d in OR_SHAPES:
        g = torch.Generator(device=dev).manual_seed(b)
        rows = [torch.randn(b, d, device=dev, generator=g) for _ in range(5)]
        ll = torch.randn(b, 2, device=dev, generator=g) * 3
        runs = {}
        for tag, pkg in mods.items():
            m = importlib.import_module(f"{pkg.__name__}.ops.sd_fused_step")
            sc = scalars((SIGMA, DSIGMA), reads_device_scalars(pkg), dev)
            runs[tag] = lambda m=m, sc=sc: m.sd_or_step(*rows, ll, *sc)

        def hold(outs):
            p, c = outs["parent"], outs["change"]
            tol_x = 1e-5 * p[0].abs().max().item()
            tol_ll = 1e-5 * (p[1] - ll).abs().max().item() + 1e-4 * ll.abs().max().item()
            errs = ((p[0] - c[0]).abs().max().item(), (p[1] - c[1]).abs().max().item(),
                    (p[2] - c[2]).abs().max().item())
            return errs, errs[0] <= tol_x and errs[1] <= tol_ll and errs[2] <= 1e-6

        yield (b, d), runs, hold, 6 * b * d * 4, b


def sde_cases(mods, dev):
    """(shape, {tag: run}, hold, bytes, rows) per ``fused_sde_step`` shape,
    made as the caller reaches it."""
    import torch

    change = mods["change"].__name__
    ito = importlib.import_module(f"{change}.core.ito")
    sched = importlib.import_module(f"{change}.core.schedules").VPSchedule()
    t, dt = torch.tensor(0.5), torch.tensor(5e-3)
    values = (sched.dlog_alpha_dt(t), sched.beta(t), sched.sigma(t), dt)
    for n, b, d in SDE_SHAPES:
        for ties in (True, False):
            g = torch.Generator(device=dev).manual_seed(n * b + d + ties)
            s, x, eps = (torch.randn(*shape, device=dev, generator=g)
                         for shape in ((n, b, d), (b, d), (b, d)))
            logq = (torch.zeros(b, n, device=dev) if ties
                    else 3 * torch.randn(b, n, device=dev, generator=g))
            runs = {}
            for tag, pkg in mods.items():
                m = importlib.import_module(f"{pkg.__name__}.ops.fused_step")
                sc = scalars(values, reads_device_scalars(pkg), dev)
                runs[tag] = lambda m=m, sc=sc: m.fused_sde_step(s, x, eps, logq, *sc)

            def hold(outs):
                p, c = outs["parent"], outs["change"]
                # logq relative to the step's increments, as chip_smoke phase 2
                dlogq = ito.dlogq_sde_vp(s, x, p[0] - x, t, dt, sched)
                tol_x = 1e-5 * p[0].abs().max().item()
                tol_lq = 1e-5 * dlogq.abs().max().item() + 1e-4 * p[1].abs().max().item()
                errs = ((p[0] - c[0]).abs().max().item(), (p[1] - c[1]).abs().max().item())
                return errs, errs[0] <= tol_x and errs[1] <= tol_lq

            yield (n, b, d, "ties" if ties else "no ties"), runs, hold, (n + 3) * b * d * 4, b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_step_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import PEAK_BYTES, card_line, empty_launch, graph_ms, step_clusters

    mods = {"parent": load_package(args.parent.resolve(), "parent_superdiff_tpu_torch"),
            "change": load_package(ROOT, "change_superdiff_tpu_torch")}
    builds = [threading.Thread(target=importlib.import_module(f"{p.__name__}.ops._build").build_all,
                               args=(("sd_fused_step", "fused_step"),)) for p in mods.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()

    card = card_line()
    print(f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    dev = torch.device("cuda", 0)
    summary, failed = {}, []
    # one case at a time: each case's runs read that case's tensors
    cases = itertools.chain((("sd_or_step", c) for c in or_cases(mods, dev)),
                            (("fused_sde_step", c) for c in sde_cases(mods, dev)))
    for name, (shape, runs, hold, nbytes, rows) in cases:
        outs = {tag: run() for tag, run in runs.items()}
        torch.cuda.synchronize()
        errs, ok = hold(outs)
        key = f"{name} {shape}"
        verdict = "held" if ok else "FAILS its hold"
        if not ok:
            failed.append(key)
        cluster = step_clusters(name, shape[-1] if name == "sd_or_step" else shape[2])
        like = outs["change"][0]
        floor = graph_ms(lambda: empty_launch(like, cluster, rows))
        del outs
        times = {tag: [] for tag in ("parent", "change")}
        for _ in range(args.rounds):
            for tag in ("parent", "change", "change", "parent"):
                times[tag].append(graph_ms(runs[tag]))
        med = {tag: statistics.median(ts) for tag, ts in times.items()}
        bound = nbytes / PEAK_BYTES * 1e3
        summary[key] = {**med, "floor": floor, "bound": bound}
        print(f"{key}: change against parent {verdict} (max diffs "
              + ", ".join(f"{e:.3e}" for e in errs) + "); device ms parent "
              + ", ".join(f"{t:.4f}" for t in times["parent"])
              + "; change " + ", ".join(f"{t:.4f}" for t in times["change"])
              + f"; medians {med['parent']:.4f} / {med['change']:.4f} "
              f"({med['change'] / med['parent'] - 1:+.2%}); empty-kernel floor {floor:.4f} "
              f"(clusters of {cluster}); bound {bound:.4f} (bytes)", flush=True)
    print(json.dumps({"card": card, "median_ms": summary, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
