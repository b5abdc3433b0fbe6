#!/usr/bin/env python3
"""``geglu_ffn_block`` of two checkouts on one card, in turns.

    python3 scripts/torch_ffn_ab.py --parent DIR [--rounds 3] [--all]

Loads ``DIR/superdiff_tpu_torch`` (another checkout, e.g. the parent commit
unpacked with ``git archive``) as a second package beside this checkout's,
builds both packages' ``geglu_ffn`` libraries with ``nvcc`` at once and
launches each through its own wrapper (``geglu_ffn._launch``) on the same
inputs at the 512 px shapes of the SD step (``--all`` adds the 768 px ones):
x (M, C) and the weights in bf16, gamma and beta in fp32 and the biases in
bf16, as the UNet stores them. The change's output is held within 2e-2 of
the parent's largest output (the kernel tolerance; h and the output are
rounded to bf16, so another accumulation order moves them by an ulp); a
failed hold is reported, the script goes on and then exits 1.

Each shape is timed in turns, parent, change, change, parent, per round, by
device time alone (``chip_smoke.graph_ms``: launches captured in a CUDA
graph and replayed), beside the composed library yardstick
(``chip_smoke.ffn_library``: LayerNorm, two cuBLAS GEMMs, the GEGLU and the
residual as plain ops, one function timed as a whole). After all timing
(a profiler session slows later launches) each side's launches are traced
with torch.profiler and split by kernel name (``geglu_ln``, ``geglu_up``,
``geglu_down`` and whatever else a call launches). One line per shape gives
every time and the medians; the last line is a JSON object with the
medians, the per-launch split, the card's name and power limit. Before the
timing, the SASS (``cuobjdump -sass``) of each of the parent's kernels is
compared with that of the change's kernel in SD's configuration (exact-erf
gelu, LN and residual): per kernel, identical or the count of instructions
that differ. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import difflib
import importlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES_512 = ((24 * 4096, 320), (24 * 1024, 640), (24 * 256, 1280), (24 * 64, 1280))
SHAPES_768 = ((24 * 9216, 320), (24 * 2304, 640), (24 * 576, 1280), (24 * 144, 1280))


def load_package(root: Path, alias: str):
    """``root/superdiff_tpu_torch`` imported as package ``alias``; returns
    its ``ops.geglu_ffn`` module (the package imports only relatively)."""
    spec = importlib.util.spec_from_file_location(
        alias, root / "superdiff_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(root / "superdiff_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.geglu_ffn")


def inputs(m, c, dev):
    """chip_smoke.py phase 2's inputs for shape (m, c)."""
    import torch

    f = 4 * c
    g = torch.Generator(device=dev).manual_seed(c)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
    bf = torch.bfloat16
    x = rnd(m, c).to(bf)
    gamma, beta = 1 + 0.1 * rnd(c), 0.1 * rnd(c)
    w1 = (rnd(2 * f, c) / c**0.5).to(bf)
    b1 = (0.1 * rnd(2 * f)).to(bf)
    w2 = (rnd(c, f) / f**0.5).to(bf)
    b2 = (0.1 * rnd(c)).to(bf)
    return x, gamma, beta, w1, b1, w2, b2


def split_by_kernel(run, calls=10):
    """Device ms per call of ``run`` by kernel name (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if e.key.startswith(("aten::", "cuda", "Activity Buffer", "Buffer Flush")):
            continue
        key = e.key.replace("(anonymous namespace)::", "")
        name = re.split(r"[(<]", key)[0].split(" ")[-1].split("::")[-1]
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def sass_by_kernel(tool, lib):
    """{mangled kernel name: its SASS instructions} of a built library, each
    instruction without its address and encoding comments. The anonymous
    namespace's name, which carries a hash of the compiled file, reads
    ``ANON`` so that two builds' names compare."""
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300).stdout
    kernels = {}
    for part in out.split("Function : ")[1:]:
        name, *lines = part.splitlines()
        code = [re.sub(r"/\*.*?\*/", "", ln).strip() for ln in lines]
        name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", name.strip())
        kernels[name] = [ln for ln in code if ln.endswith(";")]
    return kernels


def sd_configuration(name):
    """The key that pairs a change's kernel in SD's configuration with the
    parent's kernel, or None for the other configurations: the change's
    ``geglu_up<T, false>`` (erf gelu) and ``geglu_down<T, true>`` (residual)
    lose their bool template argument (``Lb0E`` / ``Lb1E`` in the mangled
    name); the parent's have none."""
    if "geglu_up" in name:
        return name.replace("Lb0E", "") if "Lb0E" in name or "Lb" not in name else None
    if "geglu_down" in name:
        return name.replace("Lb1E", "") if "Lb1E" in name or "Lb" not in name else None
    return name


def compare_sass(mods):
    """Per parent kernel: identical to the change's in SD's configuration,
    or the count of instructions that differ; None without cuobjdump."""
    from chip_smoke import cuobjdump_tool

    tool = cuobjdump_tool()
    if tool is None:
        return None
    sass = {tag: sass_by_kernel(tool, importlib.import_module(
        f"{mod.__package__}._build")._target("geglu_ffn")) for tag, mod in mods.items()}
    change = {sd_configuration(n): code for n, code in sass["change"].items()}
    verdicts = {}
    for name, code in sass["parent"].items():
        other = change.get(name)
        if other is None:
            verdicts[name] = "no counterpart in the change"
            continue
        diff = sum(1 for ln in difflib.ndiff(code, other) if ln[:1] in "+-")
        verdicts[name] = (f"identical ({len(code)} instructions)" if code == other else
                          f"{diff} lines differ ({len(code)} / {len(other)} instructions)")
    return verdicts


def erf_block_args(mod):
    """``_launch``'s arguments after the tensors for SD's block (exact-erf
    gelu, LN and residual): eps alone in checkouts whose kernel has one
    configuration, eps, approximate and fused in later ones."""
    import inspect

    return (1e-5, False, True) if "fused" in inspect.signature(mod._launch).parameters else (1e-5,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--all", action="store_true", help="also the 768 px shapes")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_ffn_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, ffn_library, graph_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    mods = {"parent": load_package(args.parent.resolve(), "parent_superdiff_tpu_torch"),
            "change": load_package(ROOT, "change_superdiff_tpu_torch")}
    builds = [threading.Thread(target=importlib.import_module(f"{m.__package__}._build").build_all,
                               args=(("geglu_ffn",),)) for m in mods.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()

    card = card_line()
    print(f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    sass = compare_sass(mods)
    print("SASS, parent against the change in SD's configuration: " + (
        "no cuobjdump found" if sass is None else
        "; ".join(f"{n} {v}" for n, v in sass.items())), flush=True)
    dev = torch.device("cuda", 0)
    shapes = SHAPES_512 + (SHAPES_768 if args.all else ())
    summary, failed, runners = {}, [], {}
    for m, c in shapes:
        data = inputs(m, c, dev)
        runs = {tag: (lambda mod=mod, data=data: mod._launch(*data, *erf_block_args(mod)))
                for tag, mod in mods.items()}
        outs = {tag: run() for tag, run in runs.items()}
        torch.cuda.synchronize()
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        mag = outs["parent"].float().abs().max().item()
        key = f"({m}, {c})"
        same = torch.equal(outs["parent"], outs["change"])
        verdict = ("bit-identical" if same else
                   f"max diff {diff:.3e} ({diff / mag:.2e} of the largest output)")
        if not diff <= 2e-2 * mag:
            failed.append(key)
            verdict += " FAILS its hold"
        del outs
        times = {tag: [] for tag in ("parent", "change", "library")}
        for _ in range(args.rounds):
            for tag in ("parent", "change", "change", "parent"):
                times[tag].append(graph_ms(runs[tag]))
            times["library"].append(graph_ms(lambda: ffn_library(*data, 1e-5)))
        med = {tag: statistics.median(ts) for tag, ts in times.items()}
        summary[key] = med
        print(f"{key}: {verdict}; device ms parent "
              + ", ".join(f"{t:.4f}" for t in times["parent"])
              + "; change " + ", ".join(f"{t:.4f}" for t in times["change"])
              + "; library " + ", ".join(f"{t:.4f}" for t in times["library"])
              + f"; medians {med['parent']:.4f} / {med['change']:.4f} "
              f"({med['change'] / med['parent'] - 1:+.2%}), library {med['library']:.4f}",
              flush=True)
        if (m, c) in SHAPES_512:
            runners[key] = (runs, data)
        del data, runs
    for key in [f"({m}, {c})" for m, c in SHAPES_512]:
        runs, _ = runners[key]
        split = {tag: split_by_kernel(run) for tag, run in runs.items()}
        summary[key]["split"] = split
        print(f"{key} per launch (profiler, device ms): "
              + "; ".join(f"{tag} " + ", ".join(f"{n} {ms:.4f}" for n, ms in s.items())
                          for tag, s in split.items()), flush=True)
    runners.clear()
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "sass": sass, "median_ms": summary, "failed": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
