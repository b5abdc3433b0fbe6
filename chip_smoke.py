#!/usr/bin/env python3
"""Chip smoke run of ``superdiff_tpu_torch`` on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--steps 4] [--seed 0] [--cifar-steps 200]

Phases, in order; any failed check raises and the script exits non-zero:

1. build: compile every hand-written kernel (``superdiff_tpu_torch/ops/csrc``)
   with ``nvcc`` for sm_90a, one process per source, all started together;
   print the build seconds and the card's name and power limit.
2. kernels: call each kernel's wrapper on the card at a tiny shape and at
   every shape the 512 px main path gives it, and hold the result against
   its plain PyTorch version on the same inputs (tolerance printed beside
   the error). Time the kernel, the plain version and, where one exists, the
   single PyTorch call computing the same function; work out the bound.
3. main path: SD-1.x UNet, CLIP text encoder and VAE decoder at their
   default (full) configs, random bf16 weights from ``--seed``, method
   ``or``, 512 px, latent batch 8 (context batch 24 with conditioning
   dedup), ``--steps`` Euler steps through ``generate``. Launch counters are
   zeroed just before and read just after, and must show every step went
   through all three kernels. Latents must be finite, kappa in [0, 1], the
   images uint8. Per-step ms is then timed after two synced warmups.
4. CIFAR joint sampler: two full-width ``vpsdeA`` ScoreUNets (36.0 M
   parameters each, bf16 compute) with drawn non-zero weights, labels tiled
   0-9, batch 100, ``--cifar-steps`` SDE/OR steps through ``make_generator``
   after two synced warmups. Counters are zeroed just before and read just
   after: every step must have launched ``fused_sde_step``, and no SD kernel.
   x0 finite, every logq row renormalised (max exactly 0), uint8 images; ms
   per step, images/s and peak memory are printed. Then a 4-step ODE/OR run
   (``torch.func.jvp`` through both bf16 nets, after a 1-step warmup) must
   be finite.
5. profiles and CPU references, after every timed run (a torch.profiler
   session slows the host's later launches for the rest of the process):
   one SD sampler run and 10 CIFAR SDE/OR steps are traced with
   torch.profiler (CIFAR: device time by kernel family), and a 64x64-latent
   SD UNet forward and a batch-4 ScoreUNet forward on the card are each held
   against the same weights in fp32 on the host CPU.

The line before the last is the kernel table as JSON: ``launches`` over its
main-path run (phase 3 for the SD kernels, phase 4 for ``fused_sde_step``),
``max_abs_err`` the worst over the checked shapes, and ``ms`` / ``plain_ms``
/ ``bound_ms`` / ``library_ms`` per main-path step (each main-path shape's
time per launch times its launches per step). The card's name and power
limit are on the line before it; the last line is
``{"ok": true, "device": {...}}``. Compiler output (registers, spills) goes
to ``chiprun_out/chip_smoke_build.txt``, the profile tables to
``chiprun_out/chip_smoke_profile.txt`` (SD) and
``chiprun_out/chip_smoke_cifar_profile.txt`` (CIFAR).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet (dense): bf16 tensor cores, HBM, and the SFU exp2 rate
# (16 per clock per SM, 132 SMs, 1.98 GHz boost clock)
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 132 * 16 * 1.98e9


def log(*a):
    print(*a, flush=True)


def time_ms(fn, budget_ms=300.0, most=50):
    """Mean device ms of ``fn`` over enough launches to fill ``budget_ms``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    iters = max(3, min(most, int(budget_ms / max(first, 1e-3))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


class Check:
    """Per-kernel record: worst error over its shapes, per-step times."""

    def __init__(self, name, source, replaces, bound_by):
        self.name, self.source, self.replaces = name, source, replaces
        self.bound_by = bound_by
        self.err = 0.0
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = None

    def add(self, shape, err, scale, tol, ms, plain_ms, bound_ms, library_ms, per_step):
        """``scale``: the plain output's largest magnitude (for the relative error)."""
        log(f"  {self.name} {shape}: max_abs_err {err:.3e} rel {err / scale:.3e} "
            f"(tol {tol:.3e})  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms  "
            f"library {'-' if library_ms is None else f'{library_ms:.4f} ms'}  "
            f"x{per_step}/step")
        if not err <= tol:
            raise AssertionError(f"{self.name} {shape}: error {err} over tolerance {tol}")
        self.err = max(self.err, err)
        self.ms += per_step * ms
        self.plain_ms += per_step * plain_ms
        self.bound_ms += per_step * bound_ms
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + per_step * library_ms

    def row(self, launches):
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": self.bound_by,
                "library_ms": self.library_ms}


def check_sd_or_step(dev):
    import torch

    from superdiff_tpu_torch.ops import sd_fused_step as m

    c = Check("sd_or_step", "superdiff_tpu_torch/ops/csrc/sd_fused_step.cu",
              "superdiff_tpu/ops/pallas/sd_fused_step.py:32", "bytes")
    for (b, d), per_step in (((3, 4096), 0), ((8, 16384), 1)):
        g = torch.Generator(device=dev).manual_seed(b)
        rows = [torch.randn(b, d, device=dev, generator=g) for _ in range(5)]
        ll = torch.randn(b, 2, device=dev, generator=g) * 3
        args = (*rows, ll, 14.6146, -0.3279)
        got = m.sd_or_step(*args)
        ref = m.sd_or_step_reference(*args)
        torch.cuda.synchronize()
        # x: elementwise fp32 (FMA contraction); ll: a sum over D in another
        # order, so relative to the magnitude of the summed terms
        err_x = (got[0] - ref[0]).abs().max().item()
        err_ll = (got[1] - ref[1]).abs().max().item()
        err_k = (got[2] - ref[2]).abs().max().item()
        tol_x = 1e-5 * ref[0].abs().max().item()
        tol_ll = 1e-5 * (ref[1] - ll).abs().max().item() + 1e-4 * ll.abs().max().item()
        err = max(err_x, err_ll, err_k)
        tol = max(tol_x, tol_ll, 1e-6)
        if err_x > tol_x or err_ll > tol_ll or err_k > 1e-6:
            raise AssertionError(f"sd_or_step ({b},{d}): x {err_x} ll {err_ll} kappa {err_k}")
        ms = time_ms(lambda: m.sd_or_step(*args))
        plain = time_ms(lambda: m.sd_or_step_reference(*args))
        bound = 6 * b * d * 4 / PEAK_BYTES * 1e3
        c.add((b, d), err, ref[0].abs().max().item(), tol, ms, plain, bound, None, per_step)
    return c


def check_flash(dev):
    import torch
    import torch.nn.functional as F

    from superdiff_tpu_torch.ops import flash_attention as m

    c = Check("flash_mha_eod", "superdiff_tpu_torch/ops/csrc/flash_attention.cu",
              "superdiff_tpu/ops/pallas/flash_attention.py:254", "operations")
    shapes = (((2, 2, 40, 256), 0), ((2, 2, 80, 576), 0),
              ((8, 8, 40, 4096), 1), ((24, 8, 40, 4096), 4), ((24, 8, 80, 1024), 5))
    for (b, h, d, l), per_step in shapes:
        g = torch.Generator(device=dev).manual_seed(l + d)
        qt = torch.randn(b, h, d, l, device=dev, generator=g).to(torch.bfloat16)
        # k as the UNet passes it: a (B,H,L,D) view of a packed projection
        k = torch.randn(b, l, h, d, device=dev, generator=g).to(torch.bfloat16)
        k = k.permute(0, 2, 1, 3)
        vt = torch.randn(b, h, d, l, device=dev, generator=g).to(torch.bfloat16)
        scale = d ** -0.5
        got = m.flash_mha_eod(qt, k, vt)
        # the plain version in fp32 on the same (bf16-valued) inputs; the
        # kernel rounds q*scale, p and its output to bf16 as the TPU kernel
        # does: bf16-level error against the largest output magnitude
        ref = m._reference_eod(qt.float(), k.float(), vt.float(), scale)
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = 2e-2 * scale
        del ref
        torch.cuda.empty_cache()
        ms = time_ms(lambda: m.flash_mha_eod(qt, k, vt))
        plain = time_ms(lambda: m._reference_eod(qt, k, vt, scale), budget_ms=500, most=5)
        # the library yardstick on (B,H,L,D) copies made outside the timing
        q_, k_, v_ = qt.transpose(2, 3).contiguous(), k.contiguous(), vt.transpose(2, 3).contiguous()
        lib = time_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_))
        del q_, k_, v_
        ops = 4 * b * h * l * l * d / PEAK_BF16
        exps = b * h * l * l / PEAK_EXP2
        nbytes = 4 * b * h * l * d * 2 / PEAK_BYTES
        c.add((b, h, d, l), err, scale, tol, ms, plain, max(ops, exps, nbytes) * 1e3, lib,
              per_step)
        del qt, k, vt, got
        torch.cuda.empty_cache()
    return c


def check_geglu(dev):
    import torch

    from superdiff_tpu_torch.ops import geglu_ffn as m

    c = Check("geglu_ffn_block", "superdiff_tpu_torch/ops/csrc/geglu_ffn.cu",
              "superdiff_tpu/ops/pallas/geglu_ffn.py:114", "operations")
    shapes = (((192, 64), 0), ((24 * 4096, 320), 5), ((24 * 1024, 640), 5),
              ((24 * 256, 1280), 5), ((24 * 64, 1280), 1))
    for (mm, cc), per_step in shapes:
        f = 4 * cc
        g = torch.Generator(device=dev).manual_seed(cc)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
        bf = torch.bfloat16
        x = rnd(mm, cc).to(bf)
        gamma, beta = 1 + 0.1 * rnd(cc), 0.1 * rnd(cc)
        w1 = (rnd(2 * f, cc) / cc**0.5).to(bf)
        b1 = (0.1 * rnd(2 * f)).to(bf)
        w2 = (rnd(cc, f) / f**0.5).to(bf)
        b2 = (0.1 * rnd(cc)).to(bf)
        args = (x, gamma, beta, w1, b1, w2, b2)
        got = m.geglu_ffn_block(*args)
        # the plain version in fp32 on the same (bf16-valued) inputs; the
        # kernel rounds LN(x), the hidden h and its output to bf16 as the TPU
        # kernel does: bf16-level error against the largest output magnitude
        ref = m._reference_block(*(a.float() for a in args))
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = 2e-2 * scale
        ms = time_ms(lambda: m.geglu_ffn_block(*args))
        plain = time_ms(lambda: m._reference_block(*args))
        ops = 6 * mm * cc * f / PEAK_BF16
        nbytes = (2 * mm * cc + 3 * f * cc) * 2 / PEAK_BYTES
        c.add((mm, cc), err, scale, tol, ms, plain, max(ops, nbytes) * 1e3, None, per_step)
    return c


def check_fused_sde_step(dev):
    import torch

    from superdiff_tpu_torch.core import ito
    from superdiff_tpu_torch.core.schedules import VPSchedule
    from superdiff_tpu_torch.ops import fused_step as m

    c = Check("fused_sde_step", "superdiff_tpu_torch/ops/csrc/fused_step.cu",
              "superdiff_tpu/ops/pallas/fused_step.py:36", "bytes")
    sched = VPSchedule()
    t, dt = torch.tensor(0.5), torch.tensor(5e-3)
    scal = (sched.dlog_alpha_dt(t), sched.beta(t), sched.sigma(t), dt)
    for (n, b, d), per_step in (((3, 10, 384), 0), ((2, 16, 256), 0), ((2, 100, 3072), 1)):
        for ties in (True, False):
            g = torch.Generator(device=dev).manual_seed(n * b + d + ties)
            s, x, eps = (torch.randn(*shape, device=dev, generator=g)
                         for shape in ((n, b, d), (b, d), (b, d)))
            logq = (torch.zeros(b, n, device=dev) if ties
                    else 3 * torch.randn(b, n, device=dev, generator=g))
            args = (s, x, eps, logq, *scal)
            got = m.fused_sde_step(*args)
            ref = m.fused_sde_step_reference(*args)
            torch.cuda.synchronize()
            # x: elementwise fp32 (FMA contraction); logq: a sum over D in
            # another order, so relative to the increments' magnitude
            dlogq = ito.dlogq_sde_vp(s, x, ref[0] - x, t, dt, sched)
            err_x = (got[0] - ref[0]).abs().max().item()
            err_lq = (got[1] - ref[1]).abs().max().item()
            tol_x = 1e-5 * ref[0].abs().max().item()
            tol_lq = 1e-5 * dlogq.abs().max().item() + 1e-4 * ref[1].abs().max().item()
            if err_x > tol_x or err_lq > tol_lq or not torch.all(got[1].max(-1).values == 0):
                raise AssertionError(f"fused_sde_step ({n},{b},{d}) ties={ties}: x {err_x} "
                                     f"(tol {tol_x}) logq {err_lq} (tol {tol_lq})")
            ms = time_ms(lambda: m.fused_sde_step(*args))
            plain = time_ms(lambda: m.fused_sde_step_reference(*args))
            bound = (n + 3) * b * d * 4 / PEAK_BYTES * 1e3
            c.add((n, b, d, "ties" if ties else "no ties"), max(err_x, err_lq),
                  ref[0].abs().max().item(), max(tol_x, tol_lq), ms, plain, bound, None,
                  0 if ties else per_step)
    return c


def unet_reference_check(mod, dev):
    """One 64x64-latent UNet forward on the card (bf16, kernels) against the
    same weights in fp32 on the host CPU (plain versions)."""
    import torch

    from superdiff_tpu_torch.models.sd.unet import SDUNet

    cpu = SDUNet(mod.unet.config, dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in mod.unet.state_dict().items()})
    cpu.eval().requires_grad_(False)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(1, 64, 64, 4, generator=g)
    ctx = torch.randn(3, 77, 768, generator=g)
    with torch.no_grad():
        got = mod.unet(x.to(dev), torch.tensor(481.0), ctx.to(dev)).cpu()
        t0 = time.perf_counter()
        ref = cpu(x, torch.tensor(481.0), ctx)
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  UNet 64x64 (bf16 kernels on the card vs fp32 plain on the CPU, "
        f"{time.perf_counter() - t0:.1f} s): relative L2 error {rel:.3e} (tol 5e-2)")
    if not (torch.isfinite(got).all() and rel < 5e-2):
        raise AssertionError(f"UNet card-vs-CPU relative error {rel}")


def profile_step(sampler, ctxs, dev):
    """Device time by kernel over one sampler run (torch.profiler); the
    table goes to chiprun_out/chip_smoke_profile.txt, the top rows here."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x, _ = sampler(*ctxs, generator=gen)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
    (ROOT / "chiprun_out" / "chip_smoke_profile.txt").write_text(table)
    log("  profile (one sampler run; top kernels by device time):")
    for line in table.splitlines()[:28]:
        log("   " + line[:160])


def draw_nonzero_(model, seed):
    """Redraw every parameter of ``model`` non-zero, as the parity tests draw
    Flax trees: fan-in-scaled normal weights, ``1 + 0.1 N`` norm scales,
    ``0.1 N`` biases. (The Flax init zeroes the CIFAR net's output layers, so
    its scores would be exactly 0 and both models identical.)"""
    import torch

    p0 = next(model.parameters())
    g = torch.Generator(device=p0.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g, device=p.device)
            if p.ndim > 1:
                p.copy_(z / p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)
    return model


def score_unet_reference_check(model, cfg, dev):
    """One ScoreUNet forward at batch 4 on the card (bf16) against the same
    weights in fp32 on the host CPU."""
    import dataclasses

    import torch

    cpu = dataclasses.replace(cfg, compute_dtype="float32").model()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval().requires_grad_(False)
    g = torch.Generator().manual_seed(12)
    x = torch.randn(4, cfg.image_size, cfg.image_size, cfg.num_channels, generator=g)
    t = torch.tensor([0.9, 0.5, 0.1, 0.01]).reshape(4, 1, 1, 1)
    y = torch.tensor([0, 3, 6, 9])
    with torch.no_grad():
        got = model(t.to(dev), x.to(dev), y.to(dev)).cpu()
        t0 = time.perf_counter()
        ref = cpu(t, x, y)
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  ScoreUNet batch 4 (bf16 on the card vs fp32 on the CPU, "
        f"{time.perf_counter() - t0:.1f} s): relative L2 error {rel:.3e} (tol 5e-2), "
        f"|score| max {ref.abs().max().item():.4f}")
    if not (torch.isfinite(got).all() and rel < 5e-2):
        raise AssertionError(f"ScoreUNet card-vs-CPU relative error {rel}")


def profile_by_family(run, path):
    """Device time of one ``run()`` by kernel family (torch.profiler); the
    table goes to ``path``. Returns ({family: ms}, wall ms under the
    profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    path.write_text(events.table(sort_by="self_device_time_total", row_limit=60))
    families = (("fused_sde_step", ("fused_sde_step",)),
                ("convolution", ("conv", "fprop", "implicit", "cudnn", "nchw", "nhwc")),
                ("gemm", ("gemm", "cutlass", "cublas", "nvjet")),
                ("softmax", ("softmax",)),
                ("reduction", ("reduce",)),
                ("elementwise / copy / cat", ("elementwise", "vectorized", "copy", "cat",
                                               "unrolled", "index", "fill")))
    totals = {}
    for e in events:
        us = e.self_device_time_total
        if us <= 0 or e.key.startswith(("aten::", "cuda", "Activity Buffer", "Buffer Flush")):
            continue  # ops, runtime calls, the profiler's own buffers
        key = e.key.lower()
        fam = next((f for f, words in families if any(w in key for w in words)), "other")
        totals[fam] = totals.get(fam, 0.0) + us / 1e3
    return totals, wall


def cifar_phase(dev, args):
    """The CIFAR joint sampler at full width (``vpsdeA``: nf 128, ch_mult
    (1,2,2,2), attention at 16 and 8, 10 classes), two models with drawn
    non-zero weights, batch 100, labels tiled 0-9, bf16 compute. Returns the
    fused_sde_step launches of the counted run, the models, the config and
    the labels."""
    import torch

    from superdiff_tpu_torch.ops.fused_step import fused_sde_step
    from superdiff_tpu_torch.pipelines import cifar

    cfg = cifar.CONFIGS["vpsdeA"]()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    models = [draw_nonzero_(m, args.seed + i) for i, m in
              enumerate(cifar.build_cifar_models([args.seed, args.seed + 1], cfg, dev))]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models[0].parameters())
    log(f"  build_cifar_models (2 x {n_params / 1e6:.2f} M fp32 parameters, drawn "
        f"non-zero): {time.perf_counter() - t0:.2f} s")
    b = cfg.eval_batch_size
    labels = torch.arange(10, device=dev).repeat(b // 10 + 1)[:b]
    warm = cifar.make_generator(models, cfg, n_steps=2, labels=labels)
    for _ in range(2):  # two synced warmups
        float(warm(torch.Generator(device=dev).manual_seed(0))[0].sum())
    generate = cifar.make_generator(models, cfg, mode="sde", operator="or",
                                    n_steps=args.cifar_steps, labels=labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_sde_step.launches = 0
    t0 = time.perf_counter()
    x0, logq = generate(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_sde_step.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"  generate (sde, or, {args.cifar_steps} steps, batch {b}): {wall:.3f} s wall, "
        f"{wall * 1e3 / args.cifar_steps:.3f} ms per step, {b / wall:.3f} images/s, "
        f"peak memory {peak:.3f} GiB; fused_sde_step launches {launches} "
        f"(want {args.cifar_steps})")
    if launches != args.cifar_steps:
        raise AssertionError(f"fused_sde_step launches {launches} != {args.cifar_steps}")
    shape = (b, cfg.image_size, cfg.image_size, cfg.num_channels)
    if x0.shape != shape or not torch.isfinite(x0).all():
        raise AssertionError(f"x0 {tuple(x0.shape)} not finite/shaped")
    if logq.shape != (b, 2) or not (torch.all(logq.max(-1).values == 0) and torch.all(logq <= 0)):
        raise AssertionError(f"logq not renormalised: {logq}")
    images = cifar.to_uint8(x0)
    if images.dtype != torch.uint8 or images.shape != shape:
        raise AssertionError(f"images {images.dtype} {tuple(images.shape)}")
    wins = [int((logq.argmax(-1) == n).sum()) for n in range(2)]
    log(f"  x0 |x|max {x0.abs().max().item():.4f}; rows won by model 0 / 1: {wins}; "
        f"logq min {logq.min().item():.6g}; images uint8 mean {images.float().mean().item():.3f}")

    ode = cifar.make_generator(models, cfg, mode="ode", operator="or", n_steps=4, labels=labels)
    float(cifar.make_generator(models, cfg, mode="ode", n_steps=1, labels=labels)()[0].sum())
    t0 = time.perf_counter()
    xo, lo = ode(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    log(f"  ode/or 4 steps after a 1-step warmup (torch.func.jvp through both bf16 "
        f"nets): {(time.perf_counter() - t0) * 1e3 / 4:.3f} ms per step, |x|max "
        f"{xo.abs().max().item():.4f}, logq min {lo.min().item():.6g}")
    if not (torch.isfinite(xo).all() and torch.isfinite(lo).all()):
        raise AssertionError("ODE sampler output not finite")
    return launches, models, cfg, labels


def cifar_profile(models, cfg, labels, dev):
    """10 CIFAR SDE/OR steps under torch.profiler: device time by kernel
    family, and the device's idle share in that same run."""
    import torch

    from superdiff_tpu_torch.pipelines import cifar

    short = cifar.make_generator(models, cfg, n_steps=10, labels=labels)
    fams, wall = profile_by_family(lambda: short(torch.Generator(device=dev).manual_seed(2)),
                                   ROOT / "chiprun_out" / "chip_smoke_cifar_profile.txt")
    total = sum(fams.values())
    log(f"  profile (10 sde/or steps): {total / 10:.3f} ms device time per step, "
        f"{wall / 10:.3f} ms wall per step under the profiler (device idle "
        f"{1 - total / wall:.3f}); by family (ms per step): " + ", ".join(
            f"{k} {v / 10:.4f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cifar-steps", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from superdiff_tpu_torch.ops import (
            _build,
            flash_attention,
            fused_step,
            geglu_ffn,
            sd_fused_step,
        )
        from superdiff_tpu_torch.pipelines import sd
    except ImportError as e:
        print(f"chip_smoke: superdiff_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    outputs = _build.build_all()
    log(f"  nvcc builds: {time.perf_counter() - t0:.2f} s ({', '.join(outputs)})")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_build.txt").write_text(
        "".join(f"== {n}\n{o}\n" for n, o in outputs.items()))
    for n, o in outputs.items():
        for line in o.splitlines():
            if "Used" in line or "spill" in line and " 0 bytes spill" not in line:
                log(f"  {n}: {line.strip()}")
    log(f"  card: {card}")

    log("phase 2: kernels vs their plain versions")
    checks = [check_sd_or_step(dev), check_flash(dev), check_geglu(dev),
              check_fused_sde_step(dev)]
    torch.cuda.empty_cache()

    log(f"phase 3: main path (SD-1.x, or, 512 px, latent batch 8, {args.steps} steps)")
    t0 = time.perf_counter()
    mod = sd.build_sd_modules(args.seed, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  build_sd_modules (random bf16 weights): {time.perf_counter() - t0:.2f} s")
    cfg = sd.SDPipelineConfig(num_inference_steps=args.steps)
    prompts = ("a cat", "a dog")
    one = sd.SDPipelineConfig(num_inference_steps=1)
    for _ in range(2):  # two synced warmups
        w = sd.generate(mod, "or", *prompts, seed=args.seed, batch_size=8, cfg=one, decode=False)
        float(w["latents"].sum())
    wrappers = (sd_fused_step.sd_or_step, flash_attention.flash_mha_eod,
                geglu_ffn.geglu_ffn_block, fused_step.fused_sde_step)
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    out = sd.generate(mod, "or", *prompts, seed=args.seed, batch_size=8, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in wrappers]
    want = [args.steps, 10 * args.steps, 16 * args.steps, 0]
    log(f"  generate: {wall:.3f} s wall; launches sd_or_step/flash_mha_eod/"
        f"geglu_ffn_block/fused_sde_step = {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    lat, kappa, img = out["latents"], out["traces"]["kappa"], out["images"]
    if lat.shape != (8, 64, 64, 4) or not torch.isfinite(lat).all():
        raise AssertionError(f"latents {tuple(lat.shape)} not finite/shaped")
    if kappa.shape != (args.steps, 8) or not ((kappa >= 0) & (kappa <= 1)).all():
        raise AssertionError(f"kappa out of [0,1]: {kappa}")
    if img.dtype != torch.uint8 or img.shape != (8, 512, 512, 3):
        raise AssertionError(f"images {img.dtype} {tuple(img.shape)}")
    log(f"  latents |x|max {lat.abs().max().item():.4f}; kappa last step "
        f"{[round(v, 6) for v in kappa[-1].tolist()]}; images {tuple(img.shape)} uint8 "
        f"mean {img.float().mean().item():.3f}")
    ctxs = sd.prepare_contexts(mod, "or", *prompts, 8)
    sampler = sd.make_sampler(mod, "or", cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, _ = sampler(*ctxs, generator=gen)
    float(x.sum())
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    log(f"  sampler: {step_ms:.3f} ms per step (UNet forward at context batch 24 + "
        f"OR epilogue), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out, lat, img, x
    torch.cuda.empty_cache()

    log(f"phase 4: CIFAR joint sampler (vpsdeA, 2 models, batch 100, sde/or, "
        f"{args.cifar_steps} steps)")
    for fn in wrappers:
        fn.launches = 0
    launches[3], models, cifar_cfg, labels = cifar_phase(dev, args)
    others = [fn.launches for fn in wrappers[:3]]
    if others != [0, 0, 0]:
        raise AssertionError(f"the CIFAR path launched SD kernels: {others}")

    log("phase 5: profiles and CPU references")
    profile_step(sampler, ctxs, dev)
    unet_reference_check(mod, dev)
    del mod, sampler, ctxs
    torch.cuda.empty_cache()
    cifar_profile(models, cifar_cfg, labels, dev)
    score_unet_reference_check(models[0], cifar_cfg, dev)

    log(card)
    print(json.dumps({"kernels": [c.row(n) for c, n in zip(checks, launches)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
