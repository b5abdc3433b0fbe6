#!/usr/bin/env python3
"""Wall time per step of the ported CIFAR joint sampler on one GPU, under
the host states that ``chip_smoke.py`` goes through before its phase 4.

    python3 scripts/torch_cifar_step_wall.py [--steps 100] [--seed 0]

Builds phase 4's two full-width ``vpsdeA`` ScoreUNets (drawn non-zero
weights, bf16 compute, batch 100, labels tiled 0-9), warms the SDE/OR
sampler up twice, then times ``--steps`` steps (host clock around one
synced run) and the host cost of one tiny CUDA op (the mean over 20 000
back-to-back ``add_`` on a 1-element tensor, synced once) in this order:

1. ``fresh``, twice;
2. ``threads``: torch's CPU threads raised to the core count, as the CPU
   reference checks once raised them; then ``threads reset``;
3. ``after kernel checks``: after ``chip_smoke.py``'s phase 2 (every
   kernel against its plain version, with its timings);
4. ``after SD run``: after phase 3's SD-1.x ``or`` generate (512 px, latent
   batch 8, 4 steps), its modules still alive as they are in
   ``chip_smoke.py`` until phase 5; then ``SD freed`` (deleted,
   ``gc.collect``, ``empty_cache``);
5. ``after profiler``: after one 2-step sampler run under torch.profiler
   (CPU and CUDA activities), as phase 5 profiles; twice.

The last two lines are the card's name and power limit and one JSON
object ``{"runs": [{"state", "ms_per_step", "op_us"}, ...]}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_cifar_step_wall: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from superdiff_tpu_torch.ops.fused_step import fused_sde_step
    from superdiff_tpu_torch.pipelines import cifar, sd

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cifar.CONFIGS["vpsdeA"]()
    models = [chip_smoke.draw_nonzero_(m, args.seed + i) for i, m in
              enumerate(cifar.build_cifar_models([args.seed, args.seed + 1], cfg, dev))]
    b = cfg.eval_batch_size
    labels = torch.arange(10, device=dev).repeat(b // 10 + 1)[:b]
    generate = cifar.make_generator(models, cfg, n_steps=args.steps, labels=labels)
    warm = cifar.make_generator(models, cfg, n_steps=2, labels=labels)
    for _ in range(2):  # two synced warmups
        float(warm(torch.Generator(device=dev).manual_seed(0))[0].sum())
    one = torch.zeros(1, device=dev)

    runs = []

    def timed(state):
        torch.cuda.synchronize()
        before = fused_sde_step.launches
        t0 = time.perf_counter()
        x0, _ = generate(torch.Generator(device=dev).manual_seed(args.seed))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        if fused_sde_step.launches - before != args.steps or not torch.isfinite(x0).all():
            raise AssertionError(f"{state}: sampler did not run its steps through the kernel")
        t0 = time.perf_counter()
        for _ in range(20000):
            one.add_(1.0)
        torch.cuda.synchronize()
        op_us = (time.perf_counter() - t0) * 1e6 / 20000
        runs.append({"state": state, "ms_per_step": ms, "op_us": op_us,
                     "threads": torch.get_num_threads()})
        print(f"  {state}: {ms:.3f} ms per step, {op_us:.3f} us per tiny op, "
              f"{torch.get_num_threads()} CPU threads", flush=True)

    timed("fresh")
    timed("fresh")
    before = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 8)
    timed("threads")
    torch.set_num_threads(before)
    timed("threads reset")
    for check in (chip_smoke.check_sd_or_step, chip_smoke.check_flash,
                  chip_smoke.check_geglu, chip_smoke.check_fused_sde_step):
        check(dev)
    torch.cuda.empty_cache()
    timed("after kernel checks")
    mod = sd.build_sd_modules(args.seed, device=dev, dtype=torch.bfloat16)
    out = sd.generate(mod, "or", "a cat", "a dog", seed=args.seed, batch_size=8,
                      cfg=sd.SDPipelineConfig(num_inference_steps=4))
    float(out["latents"].sum())
    timed("after SD run")
    del mod, out
    gc.collect()
    torch.cuda.empty_cache()
    timed("SD freed")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        float(warm(torch.Generator(device=dev).manual_seed(1))[0].sum())
    timed("after profiler")
    timed("after profiler")
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
