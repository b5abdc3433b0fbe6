#!/usr/bin/env python3
"""Kernel records that torch.profiler hands a recorded cycle from the
unrecorded run before it, as ``chip_smoke.counted_runs`` records a path.

Repeats a new CIFAR generator's first captured call of 10 SDE/OR steps
(``vpsdeA``, two models with drawn weights, batch 100: step 0 eagerly, the
capture, 9 replays), each recorded run after an unrecorded one, and prints
for each recorded run the ``fused_sde_step`` records that ``key_averages()``
holds, those that ``chip_smoke.recorded_kernels`` keeps (the records that
started inside the recorded step), and the start of every record that began
before the step, in ms from the step's start. Every cycle goes to
``chiprun_out/profile_records.json``.

    python3 scripts/torch_profile_records.py [--cycles 25] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_records: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    from superdiff_tpu_torch.pipelines import cifar

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    cfg = cifar.CONFIGS["vpsdeA"]()
    models = [cs.draw_nonzero_(m, args.seed + i) for i, m in
              enumerate(cifar.build_cifar_models([args.seed, args.seed + 1], cfg, dev))]
    b = cfg.eval_batch_size
    labels = torch.arange(10, device=dev).repeat(b // 10 + 1)[:b]
    run = lambda: cifar.make_generator(models, cfg, n_steps=10, labels=labels)(
        torch.Generator(device=dev).manual_seed(3))
    run()
    torch.cuda.synchronize()

    cycles = []

    def record(p):
        events = p.events()
        begin = min(e.time_range.start for e in events if e.name.startswith("ProfilerStep"))
        fused = [e.time_range.start for e in events
                 if e.device_type == DeviceType.CUDA and "fused_sde_step" in e.name]
        cycles.append({
            "key_averages": sum(n for fam, _, _, n in cs.device_kernels(p.key_averages())
                                if fam == "fused_sde_step"),
            "recorded_kernels": sum(n for fam, _, _, n in cs.recorded_kernels(p)
                                    if fam == "fused_sde_step"),
            "before_step_ms": [(t - begin) / 1e3 for t in fused if t < begin]})

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=args.cycles),
                 on_trace_ready=record) as prof:
        for _ in range(args.cycles):
            for _ in range(2):  # unrecorded, then recorded
                run()
                torch.cuda.synchronize()
                prof.step()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile_records.json").write_text(json.dumps(cycles, indent=1))
    ka = [c["key_averages"] for c in cycles]
    rk = [c["recorded_kernels"] for c in cycles]
    print(f"fused_sde_step records per recorded 10-step run, {args.cycles} runs:", flush=True)
    print(f"  key_averages():     {ka}", flush=True)
    print(f"  recorded_kernels(): {rk}", flush=True)
    for i, c in enumerate(cycles):
        if c["before_step_ms"]:
            print(f"  run {i}: records that started before the step, ms from its start: "
                  f"{c['before_step_ms']}", flush=True)
    print(json.dumps({"runs": args.cycles, "key_averages_not_10": sum(n != 10 for n in ka),
                      "recorded_kernels_not_10": sum(n != 10 for n in rk)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
