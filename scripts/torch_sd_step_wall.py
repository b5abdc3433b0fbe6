#!/usr/bin/env python3
"""Wall time per step of the ported SD ``or`` sampler on one GPU, for a
checkout of the repository given by ``--repo`` (this one by default), so two
commits can be timed in turns inside one process-per-commit command on one
card.

    python3 scripts/torch_sd_step_wall.py [--repo PATH] [--size 512] [--steps 4]
                                          [--runs 5] [--seed 0]

Builds the full-width SD-1.x stack of ``PATH/superdiff_tpu_torch`` with
random bf16 weights, encodes two prompts at latent batch 8 (context batch 24
with conditioning dedup), warms the sampler up twice and then times
``--runs`` runs of ``--steps`` steps each (host clock around a synced run),
then traces one more run with torch.profiler and adds up the device time of
its kernels (``device_ms_per_step``: what the card was busy, whatever the
host did). Only entry points every commit of the port has are used
(``build_sd_modules``, ``prepare_contexts``, ``make_sampler``). The last two
lines are the card's name and power limit and one JSON object
``{"repo", "size", "ms_per_step": [...], "median", "device_ms_per_step"}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_sd_step_wall: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from superdiff_tpu_torch.pipelines import sd

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = sd.build_sd_modules(args.seed, device=dev, dtype=torch.bfloat16)
    cfg = sd.SDPipelineConfig(num_inference_steps=args.steps, height=args.size,
                              width=args.size)
    ctxs = sd.prepare_contexts(mod, "or", "a cat", "a dog", 8)
    sampler = sd.make_sampler(mod, "or", cfg)
    times = []
    for run in range(args.runs + 2):  # the first two are warmups
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _ = sampler(*ctxs, generator=gen)
        float(x.sum())
        if run >= 2:
            times.append((time.perf_counter() - t0) * 1e3 / args.steps)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x, _ = sampler(*ctxs, generator=torch.Generator(device=dev).manual_seed(args.seed))
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3 / args.steps
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"repo": args.repo, "size": args.size, "ms_per_step": times,
                      "median": statistics.median(times),
                      "device_ms_per_step": device_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
