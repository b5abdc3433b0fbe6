#!/usr/bin/env python3
"""Modes 0-2 of ``flash_attention_bhld.cu`` in two checkouts, on one card.

    python3 scripts/torch_attn_modes_ab.py --parent DIR [--rounds 3]

Builds ``DIR/superdiff_tpu_torch/ops/csrc/flash_attention_bhld.cu`` (another
checkout, e.g. the parent commit unpacked with ``git archive``) and this
checkout's source with ``nvcc`` for sm_90a, one process each, and launches
both libraries on the same inputs at the SD shapes of modes 0, 1 and 2
((B,H,L,D) views of one packed projection, as ``flash_eo`` hands them over).
The two outputs must be equal bit for bit (every kv length here is a
multiple of the 64-row kv tile, so no kv-tail guard fires). Each shape is
timed with CUDA events in turns, parent, change, change, parent, per round;
one line per shape gives every time and the medians, and the last line is
a JSON object with the medians, the card's name and power limit. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("superdiff_tpu_torch/ops/csrc/flash_attention_bhld.cu")
# (TPU kernel, mode, (B, H, L, D)): the shapes phase 2 of chip_smoke.py times
SHAPES = (("_kernel", 2, (24, 8, 9216, 40)), ("_kernel", 2, (8, 8, 9216, 40)),
          ("_kernel_1block", 0, (24, 8, 4096, 40)), ("_make_pvt_kernel", 1, (24, 8, 4096, 40)),
          ("_kernel_mh", 0, (24, 8, 576, 160)), ("_kernel_mh", 0, (24, 8, 1024, 80)))


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
    from chip_smoke import card_line, time_ms
    from superdiff_tpu_torch.ops import _build
    from superdiff_tpu_torch.ops import flash_attention as fa

    out_dir = ROOT / "build" / "attn_modes_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"parent": args.parent / SOURCE, "change": ROOT / SOURCE}
    procs = {tag: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                    str(out_dir / f"{tag}.so"), str(src)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for tag, src in sources.items()}
    libs = {}
    for tag, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {tag} source:\n{out}")
        lib = libs[tag] = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        restype, argtypes = fa._SIGNATURES_BHLD["attn_bhld_launch"]
        lib.attn_bhld_launch.restype, lib.attn_bhld_launch.argtypes = restype, argtypes

    card = card_line()
    print(f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    dev = torch.device("cuda", 0)
    summary = {}
    for name, mode, (b, h, l, d) in SHAPES:
        g = torch.Generator(device=dev).manual_seed(l + d)
        qkv = torch.randn(b, l, 3, h, d, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        outs = {tag: torch.empty(b, h, l, d, dtype=torch.bfloat16, device=dev) for tag in libs}
        strides = {tag: (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
                   for tag, o in outs.items()}

        def launch(tag):
            p = _build.ptr
            err = libs[tag].attn_bhld_launch(
                p(q), p(k), p(v), p(outs[tag]), b, h, d, l, l,
                ctypes.cast(strides[tag], ctypes.c_void_p), float(d ** -0.5 * fa.LOG2_E), mode,
                _build.stream_ptr(q))
            _build.check(err, f"{tag} {name}")

        for tag in libs:
            launch(tag)
        torch.cuda.synchronize()
        if not torch.equal(outs["parent"], outs["change"]):
            diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
            raise AssertionError(f"{name} mode {mode} {(b, h, l, d)}: outputs differ by {diff}")
        times = {tag: [] for tag in libs}
        for _ in range(args.rounds):
            for tag in ("parent", "change", "change", "parent"):
                times[tag].append(time_ms(lambda: launch(tag), budget_ms=200))
        med = {tag: statistics.median(ts) for tag, ts in times.items()}
        key = f"{name} mode {mode} {(b, h, l, d)}"
        summary[key] = med
        print(f"{key}: bit-identical; parent " + ", ".join(f"{t:.4f}" for t in times["parent"])
              + "; change " + ", ".join(f"{t:.4f}" for t in times["change"])
              + f" ms; medians {med['parent']:.4f} / {med['change']:.4f} "
              f"({med['change'] / med['parent'] - 1:+.2%})", flush=True)
        del qkv, q, k, v, outs
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
