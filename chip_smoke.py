#!/usr/bin/env python3
"""Chip smoke run of ``superdiff_tpu_torch`` on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--steps 4] [--seed 0]

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
   images uint8. Per-step ms is then timed after two synced warmups, one
   more sampler run is traced with torch.profiler, and a 64x64-latent UNet
   forward on the card is held against the same weights in fp32 on the
   host CPU.

The line before the last is the kernel table as JSON: ``launches`` over the
main-path run, ``max_abs_err`` the worst over the checked shapes, and
``ms`` / ``plain_ms`` / ``bound_ms`` / ``library_ms`` per main-path step (each
main-path shape's time per launch times its launches per step). The card's
name and power limit are on the line before it; the last line is
``{"ok": true, "device": {...}}``. Compiler output (registers, spills) goes
to ``chiprun_out/chip_smoke_build.txt``, the profile table to
``chiprun_out/chip_smoke_profile.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
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

    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
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
        bound_by = "bytes" if self.name == "sd_or_step" else "operations"
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": bound_by,
                "library_ms": self.library_ms}


def check_sd_or_step(dev):
    import torch

    from superdiff_tpu_torch.ops import sd_fused_step as m

    c = Check("sd_or_step", "superdiff_tpu_torch/ops/csrc/sd_fused_step.cu",
              "superdiff_tpu/ops/pallas/sd_fused_step.py:32")
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
              "superdiff_tpu/ops/pallas/flash_attention.py:254")
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
              "superdiff_tpu/ops/pallas/geglu_ffn.py:114")
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


def unet_reference_check(mod, dev):
    """One 64x64-latent UNet forward on the card (bf16, kernels) against the
    same weights in fp32 on the host CPU (plain versions)."""
    import torch

    from superdiff_tpu_torch.models.sd.unet import SDUNet

    torch.set_num_threads(os.cpu_count() or 8)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from superdiff_tpu_torch.ops import _build, flash_attention, geglu_ffn, sd_fused_step
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
    checks = [check_sd_or_step(dev), check_flash(dev), check_geglu(dev)]
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
                geglu_ffn.geglu_ffn_block)
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    out = sd.generate(mod, "or", *prompts, seed=args.seed, batch_size=8, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in wrappers]
    want = [args.steps, 10 * args.steps, 16 * args.steps]
    log(f"  generate: {wall:.3f} s wall; launches sd_or_step/flash_mha_eod/"
        f"geglu_ffn_block = {launches} (want {want})")
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
    profile_step(sampler, ctxs, dev)
    unet_reference_check(mod, dev)

    log(card)
    print(json.dumps({"kernels": [c.row(n) for c, n in zip(checks, launches)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
