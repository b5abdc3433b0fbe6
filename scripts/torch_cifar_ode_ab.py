#!/usr/bin/env python3
"""The CIFAR joint sampler's eager steps, this checkout against another one
(e.g. the parent commit), in turns on one GPU.

    python3 scripts/torch_cifar_ode_ab.py --parent DIR [--rounds 3] [--steps 4]

Loads ``DIR/superdiff_tpu_torch`` as a second package beside this
checkout's, builds two full-width ``vpsdeA`` ScoreUNets in each (the same
drawn non-zero weights, bf16 compute, batch 100, labels tiled 0-9) and
runs the probability-flow ODE / OR (``torch.func.jvp`` through both nets)
and the eager SDE / OR (``capture=False``, ``fused_sde_step``) for
``--steps`` steps on the same injected noise: parent, change, change,
parent per round, host clock around each synced run, after two warmups
each. The two checkouts' x0 and logq must be bit-identical. Prints ms per
step, the medians and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)

    import importlib

    import torch

    if not torch.cuda.is_available():
        print("torch_cifar_ode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import card_line, draw_nonzero_
    from torch_step_kernels_ab import load_package

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkgs = {"parent": load_package(args.parent.resolve(), "parent_superdiff_tpu_torch"),
            "change": load_package(ROOT, "change_superdiff_tpu_torch")}
    cifars = {k: importlib.import_module(f"{p.__name__}.pipelines.cifar") for k, p in pkgs.items()}
    cfg = {k: c.CONFIGS["vpsdeA"]() for k, c in cifars.items()}
    models = {"change": [draw_nonzero_(m, i) for i, m in enumerate(
        cifars["change"].build_cifar_models([0, 1], cfg["change"], dev))]}
    models["parent"] = cifars["parent"].build_cifar_models(
        [m.state_dict() for m in models["change"]], cfg["parent"], dev)
    b = cfg["change"].eval_batch_size
    labels = torch.arange(10, device=dev).repeat(b // 10 + 1)[:b]
    shape = (b, 32, 32, 3)
    g = torch.Generator(device=dev).manual_seed(0)
    x1 = torch.randn(shape, generator=g, device=dev)
    normals = torch.randn((args.steps,) + shape, generator=g, device=dev)
    probes = torch.randint(0, 2, (args.steps,) + shape, generator=g, device=dev).float() * 2 - 1
    card = card_line()
    for mode, zs, kw in (("ode", probes, {}), ("sde", normals, {"capture": False})):
        gens = {k: cifars[k].make_generator(models[k], cfg[k], mode=mode, operator="or",
                                            n_steps=args.steps, labels=labels, **kw)
                for k in pkgs}
        outs, times = {}, {k: [] for k in pkgs}

        def run(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gens[k](noise=(x1, zs))
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3 / args.steps

        for k in pkgs:
            for _ in range(2):
                outs[k], _ = run(k)
        same = all(torch.equal(a, c) for a, c in zip(outs["parent"], outs["change"]))
        for _ in range(args.rounds):
            for k in ("parent", "change", "change", "parent"):
                times[k].append(run(k)[1])
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"{mode} / or, {args.steps} steps, batch {b}: x0 and logq "
              f"{'bit-identical' if same else 'DIFFER'}; ms per step parent "
              + ", ".join(f"{v:.3f}" for v in times["parent"]) + "; change "
              + ", ".join(f"{v:.3f}" for v in times["change"])
              + f"; medians {med['parent']:.3f} / {med['change']:.3f} "
              f"({med['change'] / med['parent'] - 1:+.2%})", flush=True)
        if not same:
            raise AssertionError(f"{mode}: the two checkouts' samples differ")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
