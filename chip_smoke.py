#!/usr/bin/env python3
"""Chip smoke run of ``superdiff_tpu_torch`` on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--steps 4] [--seed 0] [--cifar-steps 50]
    python3 chip_smoke.py --phase9-only   # phase 9 alone (so --phase6-only .. --phase10-only)

Phases, in order; any failed check raises and the script exits non-zero:

1. build: compile every hand-written kernel (``superdiff_tpu_torch/ops/csrc``)
   with ``nvcc`` for sm_90a, one process per source, all started together;
   print the build seconds, the count of wgmma (HGMMA) and TMA (UTMALDG,
   UTMASTG) instructions in the attention and FFN libraries (``cuobjdump
   -sass``, where installed; none is a failure, and so is any ``mma.sync``
   (HMMA) in the FFN library) and the card's name and power limit.
2. kernels: call each kernel's wrapper on the card at a tiny shape and at
   every shape the main paths give it (512 and 768 px), and hold the result
   against its plain PyTorch version on the same inputs (tolerance printed
   beside the error). The (B,H,L,D) attention kernel is checked under every
   TPU-kernel name it stands for, in all its modes, at head dims 40, 80 and
   160 and 576 to 16384 tokens, its plain version looped over (b, h) slices
   (the online-softmax ``_kernel`` twice: with ``block_k`` the card's kv
   tile, which rounds as the card does, and JAX's ``block_k``);
   the packed-layout names (``_kernel_mh_nat``, ``_kernel_cross_packed``) on
   views of packed projections, kv from 1 to 4096 (77 for the text
   cross-attention), the plain version looped over the batch.
   The d-major kernel is held both to the plain version that rounds as
   pvtd does (``_plain_1block(sum="bf16")`` on the transposed views) and to
   the fp32 ``_reference_eod``.
   The FFN kernel in its four configurations (``GEGLU_CONFIGS``): the SD
   block (LN + residual, the exact-erf polynomial) at the 512 and 768 px
   shapes, and the block with the tanh gelu and the unfused ``geglu_ffn``
   with either gelu at a tiny shape and the four 512 px shapes (no served
   path calls these three: their ``launches``, each configuration's own
   count over the main path's run, are 0).
   Time the kernel, the plain version and, where one exists, the single
   PyTorch call computing the same function (for the FFN the composed
   ``ffn_library``: LayerNorm, two cuBLAS GEMMs, GEGLU and residual as
   plain ops, the unfused entry without LayerNorm and residual, timed as
   one function); work out the bound. Every row
   also gives its device time alone (launches captured in a CUDA graph and
   replayed) and the wrapper's host cost (host clock over launches without
   a synchronise). The step epilogues ``sd_or_step`` ((3, 4100), (8, 16384),
   (8, 36864), (8, 65536)) and ``fused_sde_step`` ((3, 10, 384),
   (2, 16, 256), (2, 100, 3072), and the 2-D walkthrough's (2, 512, 2), whose
   rows of 2 take the kernel's scalar path; with and without ties) take their step
   scalars as 0-d CUDA tensors, as the captured samplers hand them over, and
   print beside their times the device time of an empty kernel on the same
   grid of clusters in the same kind of graph (the floor of one launch).
3. main path: SD-1.x UNet, CLIP text encoder and VAE decoder at their
   default (full) configs, random bf16 weights from ``--seed``, method
   ``or``, 512 px, latent batch 8 (context batch 24 with conditioning
   dedup), ``--steps`` Euler steps through ``generate``, captured (the
   default on the card: step 0 eagerly, the step captured in a CUDA graph
   and replayed for the others). Every launch count is zeroed just before
   and read just after: the captured run's wrappers count step 0 and the
   capture (a replay counts nothing; phase 5 counts the launches on the
   device), the eager twin (``capture=False``) every step, and each must
   show the steps went through their three kernels and no other. The
   captured run must equal the eager one bit for bit on the same noise
   (latents and the ``kappa``, ``ll_obj``, ``ll_bg`` traces). Latents must
   be finite, kappa in [0, 1], the images uint8. Per-step ms and peak
   memory of the captured sampler (its first call, then the kept graph)
   and its eager twin are then timed in turns on ready contexts, and
   10-step ``generate`` calls as users make them (a first captured call,
   one replaying the kept graph, eager) in turns, held bit for bit.
   3b. the same at 768 px, 2 steps: per step 5 launches each of the
   online-softmax kernel (9216 tokens), the d-major kernel (2304 tokens)
   and ``_kernel_mh`` (576 tokens, head dim 160), 16 of ``geglu_ffn_block``,
   1 of ``sd_or_step``; captured and eager, held bit for bit and timed in
   turns. Then one step at 1024 px the same way (16384-token rows in the
   online-softmax kernel, head dims 80 and 160 in the d-major kernel).
   Phases 3c-3e run their steps eagerly, each launch counted.
   3c. 512 px under ``attn_impl="flash_eo"`` (2 steps), then one step under
   every other ``_LONG_IMPL`` name and one under ``attn_impl="flash"``, each
   counted under its own TPU-kernel name; the latents under the bf16-sum
   names must be equal bit for bit, those of ``flash`` and ``flash_eo``
   within the printed tolerance.
   3d. ``and``, ``avg`` (2 steps), ``avg_ode``, ``sd_a`` (1 step) at latent
   batch 8 and ``and_ode`` (1 step after a warmup, latent batch 2, beside an
   ``or`` step of that batch): finite, ``avg`` kappa fixed, ``sd_a`` moves
   ``final_ll_uncond``.
   3e. the packed-layout paths at 512 px, latent batch 8: ``attn_impl=
   "flash_nat"`` (2 counted steps, 32 ``_kernel_mh_nat`` launches per step
   and no other attention kernel; then a timed run), one step each under
   ``_CROSS_IMPL="xpk"`` (5 ``_kernel_cross_packed``, 17 ``_kernel_mh_nat``,
   10 ``flash_mha_eod``) and ``"nat"`` (22 ``_kernel_mh_nat``, 10
   ``flash_mha_eod``) with the default ``attn_impl``, and one 768 px step
   under ``flash_nat`` (5 ``_kernel``, 27 ``_kernel_mh_nat``). Latents
   finite, kappa in [0, 1]; under each lever one step's latents within
   1e-2 of the largest latent of the same path with the packed kernels'
   plain versions and of the default path, and one UNet forward within 5e-2
   relative L2 of the plain versions'. The two-step distances are printed
   (``sd_packed_phase`` says why they are not held).
4. CIFAR joint sampler: two full-width ``vpsdeA`` ScoreUNets (36.0 M
   parameters each, bf16 compute) with drawn non-zero weights, labels tiled
   0-9, batch 100, ``--cifar-steps`` SDE/OR steps through ``make_generator``
   after two synced warmups, captured (the default on the card) and eager.
   Counters are zeroed just before and read just after: the captured run
   must have called ``fused_sde_step`` in its step 0 and capture, the
   eager twin in every step, and no SD kernel; x0 and logq of the two
   equal bit for bit. x0 finite, every logq row renormalised (max exactly
   0), uint8 images; ms per step, images/s and peak memory of both, timed in
   turns, are printed. Then a 4-step ODE/OR run
   (``torch.func.jvp`` through both bf16 nets, after a 1-step warmup) must
   be finite.
5. launches on the device, profiles and CPU references, after every timed
   run (a torch.profiler session slows the host's later launches for the
   rest of the process): one ``geglu_ffn_block`` call must launch its three
   ``geglu_*`` kernels and nothing else (no cast or elementwise kernel), one
   ``sd_or_step`` and one ``fused_sde_step`` call one kernel each. The
   counted runs: ``generate`` at 512 px (``--steps``, decoded) and at 768 px
   (2 steps), and a new CIFAR generator's 10-step call, each a first
   captured call (step 0 eagerly, the capture, the rest replayed), each
   recorded three times under torch.profiler with every count zeroed just
   before and read just after (the wrappers: 2 per per-step call): the
   kernels each wrapper's family ran on the device (the records that
   started inside the recorded run), the median of the recorded runs, must
   be its calls per step times the steps. One captured 512 px SD
   sampler run, one captured 768 px and one 1024 px step and 10 captured
   CIFAR SDE/OR steps (graphs built before) are traced with torch.profiler
   (three recorded runs each, after warm-ups): device time by kernel family,
   the device's idle share, and the kernels each step replayed (the median
   of the recorded runs: the tracer loses a record now and then, and now and
   then hands a run one more), which
   must be 1 ``sd_or_step``, 10 ``flash_mha_eod`` and 3 x 16
   ``geglu_ffn_block`` kernels per 512 px step (768 px: 5 ``_kernel``, 10
   other attention; 1024 px: 5 ``_kernel``, 10 ``flash_mha_eod``) and 1
   ``fused_sde_step`` per CIFAR step; and a
   32x32-latent SD UNet forward and a batch-4 ScoreUNet forward on the card
   are each held against the same weights in fp32 on the host CPU, as is a
   full-width ``VAEEncoder`` forward at 256 px.
6. CIFAR training and FID evaluation, in a fresh process (``main`` starts
   this script again with ``--phase6-only``, so that no torch.profiler run of
   phase 5 slows its timings): ``pipelines.cifar.train`` of the
   ``vpsde_less_5`` and ``vpsde_more_5`` configs at full width (batch 128,
   bf16, dropout 0.1) for ``--train-steps`` steps each on the synthetic
   CIFAR-10 stand-in, the loss finite and the parameters and EMA moved; ms
   per step of the loop and of synced steps after two warmups, images/s,
   peak memory; the latest checkpoint reloaded bit for bit; a second
   ``train`` call resuming to the expected step; 4 steps straight against
   2 + checkpoint + restore + 2 (bit for bit, or within 2 x the summed
   learning rates); one train step in bf16 on the card against fp32 on the
   CPU (loss and gradients within 5e-2); ``fid_stats`` over a 6 000-image
   CIFAR-10 stand-in written as files (the synthetic 60 000 cut for the
   script's time) with seed-drawn Inception weights written as a JAX-layout ``.npz``, the
   card's pool features within 1e-3 of the CPU's, Inception images/s with
   cuDNN TF32 off and on; ``evaluate_joint_fid`` over the two runs (OR,
   SDE, 200 steps, 200 samples) through the captured sampler, its wall and
   FID, its ``fused_sde_step`` wrapper calls (step 0 and the capture); then
   under torch.profiler 3 train steps (device time by family, idle share)
   and three recorded ``evaluate_joint_fid`` runs of 10 steps x 2 batches,
   whose ``fused_sde_step`` kernels on the device must be 20.
7. SE(3) protein composition, in a fresh process (``--phase7-only``), after
   phase 6: ``SE3Diffuser.default()`` (IGSO(3) tables of 1000 sigmas x 1000
   omegas, 1000 series terms; its build seconds, and the 499 stepped t of
   the 500-step schedule picking the same table rows on the card as on the
   CPU); the reference pair, Proteus (model a) and FrameDiff at the
   checkpoints' ``model_conf`` (``tests/fixtures``), and the CLI's pair,
   ``IPAConfig.proteus_like()`` / ``framediff_like()``, every parameter
   drawn non-zero from ``--seed`` (``protein_nets``: the update heads
   scaled by 0.1); ``compose`` of the reference pair, fp32 with TF32 off,
   ``OR`` at length 100, batch 1, 100 steps (num_t 101, cut from 500 for
   the script's time), then ``AND`` and
   ``mixture`` for 20 steps at length 100 and ``OR`` for 20 steps at length
   300 (cut: num_t 21): ms per step, wall and peak memory of each; every run
   finite, unit quaternions within 1e-5, kappa in [0, 1] (OR, mixture;
   AND's closed form is unbounded), atom37 (1, N, 37, 3), a PDB of N
   residues, and no kernel of the port launched (every count 0). Card
   against CPU on the same weights: one forward of each of the four nets at
   length 64 within 1e-3 of the CPU's largest output, and a 10-step
   ``compose`` of each pair on the same injected ``init_rigids`` and noise
   within ``PROTEIN_TOL`` (translations over the largest translation, and
   quaternions), while ``python -m superdiff_tpu_torch.cli protein --length
   100 --num_t 20`` runs on the card in a process of its own (the IPA
   pair): exit 0, one PDB, one JSON line. Then 5 ``OR`` steps at length 100
   under torch.profiler (device time by family, idle share; the table in
   ``chip_smoke_protein_profile.txt``).

8. struct2seq-conditioned composition, SE(3) training and the ``cifar`` /
   ``sd`` commands, in a fresh process (``--phase8-only``), after phase 7.
   Proteus at the reference checkpoint's ``model_conf`` with its struct2seq
   section enabled (c_s 256, c_z 128, seq_nums 4) and the MPNN + ESM
   conditioner at full width (ProteinMPNN 128 wide, 3 + 3 layers, k 48;
   ESM2 esm2_t33_650M, 33 x 1280, 20 heads), FrameDiff at its checkpoint's,
   drawn weights, fp32, TF32 off: the conditioner on the card against the
   CPU on the same injected draws (teacher-forced MPNN log-probs, ESM2
   representations and attentions, ``esm_s`` / ``esm_p``) within
   ``STRUCT2SEQ_TOL``; ``compose`` OR over 20 steps at length 100, batch 1,
   ``esm_rate`` 0.2: the branch runs on the steps the gate names (0, 6, 13)
   and no other, every check of phase 7's composed runs, no kernel of the
   port; the ms of a struct2seq step and of a plain step, peak memory.
   ``FrameDiffScoreNetwork`` at ``FrameDiffConfig()`` (17 M parameters)
   trained 20 steps (``make_se3_dsm_loss``, Adam lr 1e-4, warmup 100, EMA
   0.999, batch 8, length 128) on a synthetic helix family written as PDB
   files and read back by ``ProteinDataset``: loss finite, parameters and
   EMA moved; ms per step, peak memory, the idle share over 3 profiled
   steps (``chip_smoke_se3_train_profile.txt``). ``cli sd --preset tiny``
   (2 steps) and ``cli cifar`` at a tiny config (4 train steps, then
   ``fid_stats`` of a 300-image CIFAR-10 stand-in with seed-drawn
   Inception weights), on the card, each writing its outputs.

9. the SD likelihood, FLD, the 2-D walkthrough and the utilities, in a
   fresh process (``--phase9-only``), after phase 8. 9a: ``eval.nll.ode_nll``
   through the full SD-1.x UNet (bf16, random weights), 512 px, latent batch
   2, a seed-drawn uint8 batch encoded by the ``VAEEncoder``, 10 + 10 steps,
   unguided and with guidance 7.5: finite outputs, 10 ``flash_mha_eod`` and
   16 ``geglu_ffn_block`` per UNet primal (wrapper counts; kernels on the
   device over an unguided one-step grid), the unguided run against its plain-torch
   twin; ms per NLL step, walls, peak memory. 9b: FLD on seed-drawn
   features at the notebook's protocol size (10 000 / 50 000 / 10 000, d
   768): ``fld``, ``fld_repeated`` (x3), the
   card against the CPU on a 500 / 2 500 / 500 subset. 9c: the 2-D
   walkthrough in full (2 x 2000 training iterations, ``or_sde`` /
   ``or_ode`` / ``avg_sde`` over 400 steps on 512 samples): ``or_sde``'s
   mode fractions, 1 ``fused_sde_step`` per step on the device. 9d: one NLL
   step under ``utils.profiling.trace``, its families by
   ``utils.traceparse`` within 1 % of the profiler's device time,
   ``utils.profiling.device_memory_stats`` against
   ``torch.cuda.max_memory_allocated``, ``eval.aggregate`` without pandas,
   and every NCSN norm and block on the card against the CPU (fp32).
10. the parallel tier, in a fresh process (``--phase10-only``), after phase
   9, which spawns one process per visible card (W of them; NCCL over a
   localhost rendezvous; 1 on the one-card machine, where every process
   group and collective runs at size 1). A rank that raises stops the
   others and fails the phase. 10a: data-parallel ``make_train_step`` of
   ``vpsde_less_5`` (nf 128, batch 128 global, bf16, lr 2e-4), 10 steps on
   seed-drawn batches and eps: the state bit-identical across ranks, loss
   and parameters against the one-process run; step ms and the gradient
   all-reduce's share. 10b: the CIFAR joint sampler (vpsdeA, 2 models,
   batch 100, 20 SDE/OR steps) under ``score_mode="vmap"`` on
   ``make_mesh(model=min(2, W))`` against ``"unroll"`` on one rank;
   ``fused_sde_step`` once a step on each rank (wrapper counts and the
   profiler's kernels). 10c: SD ``or`` at 512 px, latent batch 8 split over
   ``data``, 2 eager steps: per step and rank ``sd_or_step`` 1,
   ``flash_mha_eod`` 10, ``geglu_ffn_block`` 16; the gathered latents
   against the one-process run. 10d: the SD-1.x UNet at published widths,
   einsum lowering, fp32, split over tp = W against the replicated
   forward: 64 all-reduces and 16 all-gathers a forward, no kernel. 10e:
   ring attention at (24, 4096, 8, 40), fp32 and bf16, against plain
   attention. 10f: the GPipe schedule over W ``TorchTransformerLayer``
   stages at ``FrameDiffConfig()``'s widths, values and gradients against
   the sequential stack. 10d-10f launch no kernel of the port.

The line before the last is the kernel table as JSON, one row per TPU kernel:
``launches`` the launches over the run of the path the kernel serves, in
calls of its wrapper: for ``sd_or_step``, ``flash_mha_eod`` and
``geglu_ffn_block`` (512 px), ``_kernel`` and ``_kernel_mh`` (768 px) and
``fused_sde_step`` (CIFAR) the kernels phase 5's counted captured runs ran
on the device (profiler); for the ``_LONG_IMPL`` kernels (phase 3c),
``_kernel_mh_nat`` (``flash_nat``) and ``_kernel_cross_packed`` (``xpk``,
phase 3e), eager runs, the wrappers' counts; ``max_abs_err`` the worst over the checked
shapes, and ``ms`` / ``plain_ms`` / ``bound_ms`` / ``library_ms`` per step of
that path (each of its shapes' time per launch times its launches per
step). The card's name and power limit are on the line before it; the last
line is ``{"ok": true, "device": {...}}``. Compiler output (registers,
spills) goes to ``chiprun_out/chip_smoke_build.txt``, the profile tables to
``chiprun_out/chip_smoke_profile.txt`` (SD 512 px),
``chiprun_out/chip_smoke_sd768_profile.txt`` and
``chiprun_out/chip_smoke_cifar_profile.txt``.
The 1024 px step's table goes beside them, to ``chip_smoke_sd1024_profile.txt``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"  # what the run writes besides its output
sys.path.insert(0, str(ROOT))
try:  # the one kernel-family taxonomy of every profile
    from superdiff_tpu_torch.utils.traceparse import ATTN_OTHER, EOD, ONLINE, family
except ImportError as e:
    sys.exit(f"chip_smoke: superdiff_tpu_torch not found beside this script ({e})")
PROMPTS = ("a cat", "a dog")

# H100 SXM data sheet (dense): bf16 tensor cores, HBM, and the SFU exp2 rate
# (16 per clock per SM, 132 SMs, 1.98 GHz boost clock)
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 132 * 16 * 1.98e9


_START = time.monotonic()


def log(*a):
    print(*a, flush=True)


def log_phase(title):
    """A phase's header, with the seconds since the script started."""
    log(f"{title} [{time.monotonic() - _START:.0f} s]")


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


def graph_ms(fn, n=20, reps=5):
    """Device ms per call of ``fn`` with the host out of the way: ``n`` calls
    captured in one CUDA graph, replayed ``reps`` times between two events."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del g
    torch.cuda.empty_cache()
    return ms


def host_ms(fn, n=50):
    """Host ms per call of ``fn`` (the wrapper's checks, tensor maps and
    launch): the host clock over ``n`` calls with no synchronisation."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def cuobjdump_tool():
    """The path of ``cuobjdump`` (CUDA's, else triton's copy), or None."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        return tool
    try:
        import triton
    except ImportError:
        return None
    tool = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    return str(tool) if tool.exists() else None


def sass_facts(names=("flash_attention", "flash_attention_bhld", "geglu_ffn")):
    """Counts of wgmma (HGMMA), TMA (UTMALDG / UTMASTG) and mma.sync (HMMA)
    instructions in the built attention and FFN libraries, from ``cuobjdump
    -sass``; None where no cuobjdump is installed."""
    from superdiff_tpu_torch.ops import _build

    tool = cuobjdump_tool()
    if tool is None:
        return None
    facts = {}
    for n in names:
        sass = subprocess.run([tool, "-sass", str(_build._target(n))], capture_output=True,
                              text=True, timeout=300).stdout
        facts[n] = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")}
    return facts


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

    def add(self, shape, err, scale, tol, ms, plain_ms, bound_ms, library_ms, per_step,
            split=None):
        """``scale``: the plain output's largest magnitude (for the relative
        error); ``split``: (device-only ms, host-only ms) of one launch."""
        extra = "" if split is None else f"device-only {split[0]:.4f} ms  host {split[1]:.4f} ms  "
        log(f"  {self.name} {shape}: max_abs_err {err:.3e} rel {err / scale:.3e} "
            f"(tol {tol:.3e})  "
            f"kernel {ms:.4f} ms  {extra}plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms  "
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


def step_kernel_row(c, name, shape, err, scale, tol, run, plain, bound, floor, per_step):
    """Time one step-epilogue kernel (``run``: a call of its wrapper whose
    step scalars are 0-d CUDA tensors, so it can be captured) and add its
    row: the host-loop time, the device time alone (``graph_ms``), the
    wrapper's host cost, the plain version and, printed beside them, the
    device time of an empty kernel on the same grid of clusters in the same
    kind of graph (``floor``: the launch's own floor)."""
    ms = time_ms(run)
    split = (graph_ms(run), host_ms(run))
    plain_ms = time_ms(plain)
    floor_ms = graph_ms(floor)
    log(f"  {name} {shape}: empty-kernel floor {floor_ms:.4f} ms device-only; device-only "
        f"time {split[0] / bound:.2f}x its bound")
    c.add(shape, err, scale, tol, ms, plain_ms, bound, None, per_step, split)


def step_clusters(name, d):
    """CTAs a row (the cluster) of a step epilogue's launch at row length
    ``d`` on 16-byte aligned rows: 8 for ``sd_or_step`` (``kCluster`` of
    ``sd_fused_step.cu``); for ``fused_sde_step`` one 16-byte unit a thread
    of 256, 1 to 4 CTAs (``cluster_size`` of ``fused_step.cu``)."""
    if name == "sd_or_step":
        return 8
    units = d // 4 if d % 4 == 0 else d
    return min(4, max(1, -(-units // 256)))


def empty_launch(like, cluster, rows):
    """An empty kernel on ``rows`` clusters of ``cluster`` CTAs of 256
    threads (``scripts/csrc/launch_floor.cu``, built at first use) on the
    stream of ``like``'s device: the floor of one launch, timed beside the
    step epilogues; not a kernel of any path."""
    import ctypes

    from superdiff_tpu_torch.ops import _build

    lib = _build.load("launch_floor", {"launch_floor": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}, csrc=ROOT / "scripts" / "csrc")
    _build.check(lib.launch_floor(cluster, rows, _build.stream_ptr(like)), "launch_floor")


def check_sd_or_step(dev):
    import torch

    from superdiff_tpu_torch.ops import sd_fused_step as m

    c = Check("sd_or_step", "superdiff_tpu_torch/ops/csrc/sd_fused_step.cu",
              "superdiff_tpu/ops/pallas/sd_fused_step.py:32", "bytes")
    # the step scalars as the sampler hands them over: 0-d views of a device table
    scal = torch.tensor([14.6146, -0.3279], device=dev)
    sigma, dsigma = scal.unbind()
    # (3, 4100): a row split unevenly over a cluster; 512, 768 and 1024 px
    for (b, d), per_step in (((3, 4100), 0), ((8, 16384), 1), ((8, 36864), 0),
                             ((8, 65536), 0)):
        g = torch.Generator(device=dev).manual_seed(b)
        rows = [torch.randn(b, d, device=dev, generator=g) for _ in range(5)]
        ll = torch.randn(b, 2, device=dev, generator=g) * 3
        args = (*rows, ll, sigma, dsigma)
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
        cluster = step_clusters("sd_or_step", d)
        log(f"  sd_or_step ({b}, {d}): one launch on {b} clusters of {cluster} CTAs")
        step_kernel_row(c, "sd_or_step", (b, d), err, ref[0].abs().max().item(), tol,
                        lambda: m.sd_or_step(*args), lambda: m.sd_or_step_reference(*args),
                        6 * b * d * 4 / PEAK_BYTES * 1e3,
                        lambda: empty_launch(rows[0], cluster, b), per_step)
    return c


def check_flash(dev):
    """The d-major kernel (``flash_mha_eod``) at a tiny shape, a partial q
    tile and every 512 / 768 / 1024 px shape, held against two plain
    versions: ``_plain_1block(sum="bf16")`` on the transposed views, which
    rounds as pvtd does (q * scale, p and the output to bf16), and the fp32
    ``_reference_eod``."""
    import torch
    import torch.nn.functional as F

    from superdiff_tpu_torch.ops import flash_attention as m

    c = Check("flash_mha_eod", "superdiff_tpu_torch/ops/csrc/flash_attention.cu",
              "superdiff_tpu/ops/pallas/flash_attention.py:254", "operations")
    # the last four: the 768 px level-1 rows, and levels 1 and 2 at 1024 px
    # (576 tokens: a partial last q tile of 128 rows, and at D = 80 a
    # partial last kv tile of 128)
    shapes = (((2, 2, 40, 256), 0), ((2, 2, 80, 576), 0), ((2, 2, 160, 576), 0),
              ((8, 8, 40, 4096), 1), ((24, 8, 40, 4096), 4), ((24, 8, 80, 1024), 5),
              ((24, 8, 80, 2304), 0), ((24, 8, 80, 4096), 0), ((24, 8, 160, 1024), 0))
    for (b, h, d, l), per_step in shapes:
        g = torch.Generator(device=dev).manual_seed(l + d)
        qt = torch.randn(b, h, d, l, device=dev, generator=g).to(torch.bfloat16)
        # k as the UNet passes it: a (B,H,L,D) view of a packed projection
        k = torch.randn(b, l, h, d, device=dev, generator=g).to(torch.bfloat16)
        k = k.permute(0, 2, 1, 3)
        vt = torch.randn(b, h, d, l, device=dev, generator=g).to(torch.bfloat16)
        sm_scale = d ** -0.5
        got = m.flash_mha_eod(qt, k, vt)
        torch.cuda.synchronize()
        # (1) the plain version that rounds as pvtd, looped over (b, h)
        # slices (a whole shape's logits do not fit the card): bf16-level,
        # the accumulation order differs
        err_bf, mag_bf = 0.0, 0.0
        for i in range(b):
            for j in range(h):
                sl = (slice(i, i + 1), slice(j, j + 1))
                ref = m._plain_1block(qt[sl].transpose(2, 3), k[sl], vt[sl].transpose(2, 3),
                                      sm_scale, "bf16").transpose(2, 3).float()
                err_bf = max(err_bf, (got[sl].float() - ref).abs().max().item())
                mag_bf = max(mag_bf, ref.abs().max().item())
        # (2) the fp32 reference on the same (bf16-valued) inputs
        ref = m._reference_eod(qt.float(), k.float(), vt.float(), sm_scale)
        err32 = (got.float() - ref).abs().max().item()
        mag32 = ref.abs().max().item()
        del ref
        torch.cuda.empty_cache()
        log(f"  flash_mha_eod {(b, h, d, l)}: vs the bf16-sum plain version {err_bf:.3e} "
            f"(tol {1.2e-2 * mag_bf:.3e}); vs fp32 _reference_eod {err32:.3e} "
            f"(tol {2e-2 * mag32:.3e})")
        if not err32 <= 2e-2 * mag32:
            raise AssertionError(f"flash_mha_eod {(b, h, d, l)}: fp32 error {err32}")
        run = lambda: m.flash_mha_eod(qt, k, vt)
        ms = time_ms(run)
        split = (graph_ms(run), host_ms(run))
        plain = time_ms(lambda: m._reference_eod(qt, k, vt, sm_scale), budget_ms=500, most=5)
        # the library yardstick on (B,H,L,D) copies made outside the timing
        q_, k_, v_ = qt.transpose(2, 3).contiguous(), k.contiguous(), vt.transpose(2, 3).contiguous()
        lib = time_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_))
        del q_, k_, v_
        ops = 4 * b * h * l * l * d / PEAK_BF16
        exps = b * h * l * l / PEAK_EXP2
        nbytes = 4 * b * h * l * d * 2 / PEAK_BYTES
        c.add((b, h, d, l), err_bf, mag_bf, 1.2e-2 * mag_bf, ms, plain,
              max(ops, exps, nbytes) * 1e3, lib, per_step, split)
        del qt, k, vt, got
        torch.cuda.empty_cache()
    return c


def time_once_ms(fn):
    """Device ms of one synced ``fn()`` (for the sliced plain versions, which
    take seconds; the comparison run before it was the warmup)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# TPU kernel of flash_attention.py -> (line, the _LONG_IMPL names that reach it)
BHLD_KERNELS = {
    "_kernel": (61, ()),
    "_kernel_1block": (102, ("1block",)),
    "_kernel_1block_mxsum": (124, ("mxsum",)),
    "_make_pipe_kernel": (157, ("pipe2", "pipe4")),
    "_make_pvt_kernel": (199, ("pvt1", "pvt2", "pvt4")),
    "_kernel_mh": (364, ()),
    "_kernel_mh_nat": (397, ()),
    "_kernel_cross_packed": (437, ()),
}


def check_bhld(dev):
    """The single-block modes (both sums) and the online-softmax mode of
    ``flash_attention_bhld.cu`` under every TPU-kernel name, each against
    its own mode's plain version looped over (b, h) slices (the logits of a
    whole main-path shape do not fit the card). ``_kernel`` is held twice:
    to ``_plain_multiblock`` with ``block_k`` the card's kv tile (the
    rounding the card does, step for step) and with JAX's ``block_k`` (the
    running maximum moves over other widths), both at the kernel tolerance.
    ``per_step`` counts the launches of the path the kernel serves: the
    768 px ``or`` step for ``_kernel`` and ``_kernel_mh``, the 512 px
    ``flash_eo`` / ``flash`` step for the ``_LONG_IMPL`` kernels."""
    import torch
    import torch.nn.functional as F

    from superdiff_tpu_torch.ops import flash_attention as m

    def plain(name, q, k, v, bq, bk):
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
        for b in range(q.shape[0]):
            for h in range(q.shape[1]):
                sl = (slice(b, b + 1), slice(h, h + 1))
                out[sl] = m._plain(name, q[sl], k[sl], v[sl], q.shape[3] ** -0.5, bq, bk)
        return out

    long_rows = (((2, 2, 2048, 40), 0), ((8, 8, 4096, 40), 1), ((24, 8, 4096, 40), 4))
    mid_rows = (((2, 2, 576, 160), 0), ((24, 8, 576, 160), 5), ((24, 8, 1024, 80), 0))
    # ((B, H, L, D), launches per step[, the caller's block_k])
    plan = {
        "_kernel": (((2, 2, 4608, 40), 0), ((8, 8, 9216, 40), 1), ((24, 8, 9216, 40), 4),
                    ((8, 8, 16384, 40), 0),   # level 0 at 1024 px
                    # one kv block, which dispatch never hands to this kernel:
                    # one pass against the two passes of the rows below
                    ((24, 8, 4096, 40), 0),
                    # D = 80 reaches it only through a caller's block_k: 3 blocks
                    ((24, 8, 2304, 80), 0, 768)),
        "_kernel_mh": mid_rows,
        "_kernel_1block": long_rows + tuple((s, 0) for s, _ in mid_rows[1:]),
        "_kernel_1block_mxsum": long_rows,
        "_make_pipe_kernel": long_rows,
        "_make_pvt_kernel": long_rows + tuple((s, 0) for s, _ in mid_rows[1:]),
    }
    checks = {}
    for name, shapes in plan.items():
        line, impls = BHLD_KERNELS[name]
        c = checks[name] = Check(
            f"flash_mha_bhld:{name}", "superdiff_tpu_torch/ops/csrc/flash_attention_bhld.cu",
            f"superdiff_tpu/ops/pallas/flash_attention.py:{line}", "operations")
        for (b, h, l, d), per_step, *caller_bk in shapes:
            g = torch.Generator(device=dev).manual_seed(l + d)
            # (B,H,L,D) views of one packed projection, as flash_eo hands them over
            qkv = torch.randn(b, l, 3, h, d, device=dev, generator=g).to(torch.bfloat16)
            q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
            kw = {"block_k": caller_bk[0]} if caller_bk else {}
            block_q, block_k = m._blocks(l, l, None, kw.get("block_k"))
            m._LONG_IMPL = impls[0] if impls else "pvt1"
            if m._tiles(block_q, block_k, l) and m._kernel_name(l, block_k) == name:
                run = lambda: m.flash_mha_bhld(q, k, v, **kw)  # the public entry picks it
            elif per_step:
                raise AssertionError(f"dispatch: {(l, d)} reaches "
                                     f"{m._kernel_name(l, block_k)}, not {name}")
            else:
                # a shape this name is not dispatched to: the kernel directly
                run = lambda: m._launch_bhld(q, k, v, d ** -0.5, name)
            before = m.flash_mha_bhld.launches[name]
            got = run()
            torch.cuda.synchronize()
            if m.flash_mha_bhld.launches[name] != before + 1:
                raise AssertionError(f"{name} {(b, h, l, d)}: the wrapper did not count a launch")
            # both round p and the output to bf16, at other places in the sum:
            # the bf16-level bound measured for the d-major kernel (3.9e-3 on
            # outputs up to 0.34), relative to the largest output
            if name == "_kernel":
                tile = m._kv_tile(d, l, name)
                ref = plain(name, q, k, v, block_q, tile)
                jax_ref = plain(name, q, k, v, block_q, block_k)
                err_jax = (got.float() - jax_ref.float()).abs().max().item()
                tol_jax = 1.2e-2 * jax_ref.float().abs().max().item()
                log(f"  flash_mha_bhld:_kernel {(b, h, l, d)}: against the card's kv tile "
                    f"{tile} (the row below); against JAX's block_k {block_k}: max_abs_err "
                    f"{err_jax:.3e} (tol {tol_jax:.3e})")
                if not err_jax <= tol_jax:
                    raise AssertionError(f"_kernel {(b, h, l, d)}: {err_jax} from the plain "
                                         f"version at JAX's block_k {block_k}")
                del jax_ref
            else:
                ref = plain(name, q, k, v, block_q, block_k)
            scale = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 1.2e-2 * scale
            ms = time_ms(run, budget_ms=200)
            split = (graph_ms(run), host_ms(run))
            m._LONG_IMPL = "pvt1"
            plain_ms = time_once_ms(lambda: plain(name, q, k, v, block_q, block_k))
            q_, k_, v_ = q.contiguous(), k.contiguous(), v.contiguous()
            lib = time_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_), budget_ms=200)
            del q_, k_, v_
            ops = 4 * b * h * l * l * d / PEAK_BF16
            exps = b * h * l * l / PEAK_EXP2
            nbytes = 4 * b * h * l * d * 2 / PEAK_BYTES
            c.add((b, h, l, d), err, scale, tol, ms, plain_ms, max(ops, exps, nbytes) * 1e3,
                  lib, per_step, split)
            del qkv, q, k, v, got, ref
            torch.cuda.empty_cache()
    return checks


# (B, Lq, D, Lk, launches per step[, "neg": all-negative logits]); H = 8 but
# on the tiny rows (B <= 2, H = 2). Cross-attention rows of the 512 px step:
_CROSS_512 = ((24, 4096, 40, 77, 5), (24, 1024, 80, 77, 5), (24, 256, 160, 77, 5),
              (24, 64, 160, 77, 1))
PACKED_PLAN = {
    "_kernel_mh_nat": (
        ((2, 256, 40, 77, 0), (1, 200, 80, 1, 0), (1, 130, 160, 130, 0),
         (1, 130, 40, 5, 0), (2, 200, 80, 128, 0), (1, 128, 160, 128, 0),
         (8, 4096, 40, 4096, 1), (24, 4096, 40, 4096, 4), (24, 1024, 80, 1024, 5),
         (24, 256, 160, 256, 5), (24, 64, 160, 64, 1)) + _CROSS_512
        # 768 px: the rows of one kv block
        + ((24, 2304, 80, 2304, 0), (24, 576, 160, 576, 0), (24, 144, 160, 144, 0))),
    "_kernel_cross_packed": (
        (2, 256, 40, 77, 0), (2, 256, 40, 77, 0, "neg"), (2, 256, 80, 77, 0),
        (2, 256, 80, 77, 0, "neg"), (1, 128, 80, 128, 0), (1, 130, 160, 5, 0),
        (24, 4096, 40, 77, 5), (24, 9216, 40, 77, 0)),
}


def check_packed(dev):
    """The packed-layout modes of ``flash_attention_bhld.cu`` (``_kernel_mh_nat``,
    ``_kernel_cross_packed``) on views of packed projections, as the UNet
    hands them over (self-attention: one (B, L, 3, H, D) projection; cross:
    q (B, L, H*D), k and v (B, 77, H*D)), each against its plain version
    looped over the batch. Tiny shapes first (a partial q tile, kv 1, 5, 77, 128
    and 130; all-negative logits for the zero shift of ``_kernel_cross_packed``),
    then every shape of the 512 and 768 px steps. ``per_step``: the 512 px
    ``flash_nat`` step for ``_kernel_mh_nat``, the 512 px ``xpk`` step for
    ``_kernel_cross_packed``."""
    import torch
    import torch.nn.functional as F

    from superdiff_tpu_torch.ops import flash_attention as m

    checks = {}
    for name, shapes in PACKED_PLAN.items():
        line = BHLD_KERNELS[name][0]
        c = checks[name] = Check(
            f"flash_mha:{name}", "superdiff_tpu_torch/ops/csrc/flash_attention_bhld.cu",
            f"superdiff_tpu/ops/pallas/flash_attention.py:{line}",
            "operations" if name == "_kernel_mh_nat" else "bytes")
        for b, lq, d, lk, per_step, *neg in shapes:
            h = 8 if b > 2 else 2
            g = torch.Generator(device=dev).manual_seed(lq + lk + d)
            rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
            if lq == lk:
                q, k, v = rnd(b, lq, 3, h, d).to(torch.bfloat16).unbind(2)
            else:
                q = rnd(b, lq, h, d).to(torch.bfloat16)
                k, v = (rnd(b, lk, h, d).to(torch.bfloat16) for _ in range(2))
            if neg:
                q, k = q.abs(), -k.abs()
            block_q, block_k = m._blocks(lq, lk, None, None)
            native = name == "_kernel_mh_nat"
            m._CROSS_IMPL = "einsum" if native else "xpk"
            if m._packed_kernel_name(lq, lk, h, block_q, block_k, native) == name:
                run = lambda: m.flash_mha(q, k, v, native_long_kv=native)
            elif per_step:
                raise AssertionError(f"dispatch: {(b, lq, d, lk)} does not reach {name}")
            else:
                run = lambda: m._launch_packed(q, k, v, d ** -0.5, name)
            before = m.flash_mha.launches[name]
            got = run()
            torch.cuda.synchronize()
            if m.flash_mha.launches[name] != before + 1:
                raise AssertionError(f"{name} {(b, lq, d, lk)}: the wrapper did not count a launch")
            if not got.is_contiguous():
                raise AssertionError(f"{name}: the output is not written packed")

            def plain():
                return torch.cat([m._plain(name, *(a[i:i + 1].transpose(1, 2) for a in (q, k, v)),
                                           d ** -0.5, None, None).transpose(1, 2)
                                  for i in range(b)])

            ref = plain()
            scale = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 1.2e-2 * scale  # bf16-level, as the other attention rows
            ms = time_ms(run, budget_ms=200)
            split = (graph_ms(run), host_ms(run))
            m._CROSS_IMPL = "einsum"
            plain_ms = time_once_ms(plain)
            q_, k_, v_ = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_), budget_ms=200)
            del q_, k_, v_
            ops = 4 * b * h * lq * lk * d / PEAK_BF16
            exps = b * h * lq * lk / PEAK_EXP2
            nbytes = 2 * (lq + lk) * b * h * d * 2 / PEAK_BYTES
            c.add((b, lq, h, d, lk, *neg), err, scale, tol, ms, plain_ms,
                  max(ops, exps, nbytes) * 1e3, lib, per_step, split)
            del q, k, v, got, ref
            torch.cuda.empty_cache()
    return checks


def ffn_library(x, gamma, beta, w1, b1, w2, b2, eps, approximate=False, fused=True):
    """The FFN as PyTorch calls (cuBLAS GEMMs, plain GEGLU, and for the
    block LayerNorm and residual): the library yardstick of
    ``geglu_ffn_block`` (``fused``) and ``geglu_ffn``, timed as a whole and
    used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    xn = (F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(), eps).to(x.dtype)
          if fused else x)
    v, g = torch.addmm(b1.to(x.dtype), xn, w1.t()).chunk(2, dim=-1)
    h = (v * F.gelu(g.float(), approximate="tanh" if approximate else "none")).to(x.dtype)
    out = torch.addmm(b2.to(x.dtype), h, w2.t())
    return out + x if fused else out


# the FFN kernel's four configurations: (row name, LN + residual, tanh gelu);
# SD runs the first, no served path the other three
GEGLU_CONFIGS = (("geglu_ffn_block", True, False), ("geglu_ffn_block[tanh]", True, True),
                 ("geglu_ffn[erf]", False, False), ("geglu_ffn[tanh]", False, True))


def check_geglu(dev):
    """Every configuration of the FFN kernel against its plain version: the
    SD block (exact-erf polynomial, LN + residual) at the 512 and 768 px
    shapes, the other three at a tiny shape and the four 512 px ones."""
    import torch

    from superdiff_tpu_torch.ops import geglu_ffn as m

    # the last four: the 768 px rows (9216, 2304, 576 and 144 tokens at batch 24)
    sd_shapes = (((192, 64), 0), ((24 * 4096, 320), 5), ((24 * 1024, 640), 5),
                 ((24 * 256, 1280), 5), ((24 * 64, 1280), 1),
                 ((24 * 9216, 320), 0), ((24 * 2304, 640), 0), ((24 * 576, 1280), 0),
                 ((24 * 144, 1280), 0))
    checks = {}
    for name, fused, tanh in GEGLU_CONFIGS:
        c = checks[name] = Check(name, "superdiff_tpu_torch/ops/csrc/geglu_ffn.cu",
                                 "superdiff_tpu/ops/pallas/geglu_ffn.py:114", "operations")
        # per_step: launches in a 512 px SD step (only the SD block has any);
        # the other configurations' times are those of one call at each shape
        shapes = sd_shapes if name == "geglu_ffn_block" else tuple(
            (shape, 1) for shape, _ in sd_shapes[:5])
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
            if fused:
                args = (x, gamma, beta, w1, b1, w2, b2)
                run = lambda: m.geglu_ffn_block(*args, approximate=tanh)
                plain = lambda *a: m._reference_block(*a, approximate=tanh)
            else:
                args = (x, w1, b1, w2, b2)
                run = lambda: m.geglu_ffn(*args, approximate=tanh)
                plain = lambda *a: m._reference(*a, approximate=tanh)
            got = run()
            # the plain version in fp32 on the same (bf16-valued) inputs; the
            # kernel rounds LN(x), the hidden h and its output to bf16 as the
            # TPU kernel does: bf16-level error against the largest output
            ref = plain(*(a.float() for a in args))
            torch.cuda.synchronize()
            err = (got.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = 2e-2 * scale
            ms = time_ms(run)
            split = (graph_ms(run), host_ms(run))
            plain_ms = time_ms(lambda: plain(*args))
            lib = graph_ms(lambda: ffn_library(x, gamma, beta, w1, b1, w2, b2, 1e-5, tanh,
                                               fused))
            ops = 6 * mm * cc * f / PEAK_BF16
            nbytes = (2 * mm * cc + 3 * f * cc) * 2 / PEAK_BYTES
            c.add((mm, cc), err, scale, tol, ms, plain_ms, max(ops, nbytes) * 1e3, lib,
                  per_step, split)
            del x, w1, w2, got, ref, args
            torch.cuda.empty_cache()
    return checks


def profiled_kernels(run):
    """The kernel names one ``run()`` launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e.key for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("cuda", "Activity Buffer", "Buffer Flush"))]


def geglu_launches_only(dev):
    """One ``geglu_ffn_block`` call (SD's (M, 320) block at 64 tokens, the
    UNet's dtypes) under torch.profiler: its kernels must be the three
    ``geglu_*`` launches and nothing else (no cast of the biases, no
    elementwise kernel)."""
    import torch

    from superdiff_tpu_torch.ops import geglu_ffn as m

    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, device=dev, generator=g).to(dt)
    args = (rnd(24 * 64, 320), rnd(320, dt=torch.float32), rnd(320, dt=torch.float32),
            rnd(2560, 320), rnd(2560), rnd(320, 1280), rnd(320))
    kernels = profiled_kernels(lambda: m.geglu_ffn_block(*args))
    names = [k.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]
             for k in kernels]
    log(f"  geglu_ffn_block, one call under the profiler: {len(kernels)} kernels "
        f"({', '.join(names)})")
    if len(kernels) != 3 or not all("geglu_" in k for k in kernels):
        raise AssertionError(f"geglu_ffn_block launched other kernels: {kernels}")


def step_kernels_launch_once(dev):
    """One ``sd_or_step`` call at (8, 16384) and one ``fused_sde_step`` call
    at (2, 100, 3072), scalars on the card as the captured step hands them
    over, under torch.profiler: each must be one kernel launch and nothing
    else."""
    import torch

    from superdiff_tpu_torch.ops import fused_step, sd_fused_step

    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    scal = (rnd(4).abs() + 0.1).unbind()
    rows, ll = [rnd(8, 16384) for _ in range(5)], rnd(8, 2)
    s, x, eps, logq = rnd(2, 100, 3072), rnd(100, 3072), rnd(100, 3072), rnd(100, 2)
    runs = {"sd_or_step": lambda: sd_fused_step.sd_or_step(*rows, ll, *scal[:2]),
            "fused_sde_step": lambda: fused_step.fused_sde_step(s, x, eps, logq, *scal)}
    for name, run in runs.items():
        kernels = profiled_kernels(run)
        short = [k.replace("(anonymous namespace)::", "").split("(")[0] for k in kernels]
        log(f"  {name}, one call under the profiler: {len(kernels)} kernel(s) "
            f"({', '.join(short)})")
        if len(kernels) != 1 or name not in kernels[0]:
            raise AssertionError(f"{name}: one call launched {kernels}")


def check_fused_sde_step(dev):
    import torch

    from superdiff_tpu_torch.core import ito
    from superdiff_tpu_torch.core.schedules import VPSchedule
    from superdiff_tpu_torch.ops import fused_step as m

    c = Check("fused_sde_step", "superdiff_tpu_torch/ops/csrc/fused_step.cu",
              "superdiff_tpu/ops/pallas/fused_step.py:36", "bytes")
    sched = VPSchedule()
    t, dt = torch.tensor(0.5), torch.tensor(5e-3)
    # the step scalars as the sampler hands them over: 0-d views of a device table
    host = (sched.dlog_alpha_dt(t), sched.beta(t), sched.sigma(t), dt)
    scal = torch.stack(host).to(dev).unbind()
    # (2, 512, 2): the 2-D walkthrough's or_sde (phase 9c), D not a multiple
    # of 4, so the kernel's scalar path
    for (n, b, d), per_step in (((3, 10, 384), 0), ((2, 16, 256), 0), ((2, 100, 3072), 1),
                                ((2, 512, 2), 0)):
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
            cluster = step_clusters("fused_sde_step", d)
            shape = (n, b, d, "ties" if ties else "no ties")
            log(f"  fused_sde_step {shape}: one launch on {b} clusters of {cluster} CTAs")
            step_kernel_row(c, "fused_sde_step", shape, max(err_x, err_lq),
                            ref[0].abs().max().item(), max(tol_x, tol_lq),
                            lambda: m.fused_sde_step(*args),
                            lambda: m.fused_sde_step_reference(*args),
                            (n + 3) * b * d * 4 / PEAK_BYTES * 1e3,
                            lambda: empty_launch(x, cluster, b), 0 if ties else per_step)
    return c


def unet_reference_check(mod, dev):
    """One 32x32-latent UNet forward on the card (bf16, kernels: 1024-token
    rows through ``flash_mha_eod``) against the same weights in fp32 on the
    host CPU (plain versions)."""
    import torch

    from superdiff_tpu_torch.models.sd.unet import SDUNet

    cpu = SDUNet(mod.unet.config, dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in mod.unet.state_dict().items()})
    cpu.eval().requires_grad_(False)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(1, 32, 32, 4, generator=g)
    ctx = torch.randn(3, 77, 768, generator=g)
    with torch.no_grad():
        got = mod.unet(x.to(dev), torch.tensor(481.0), ctx.to(dev)).cpu()
        t0 = time.perf_counter()
        ref = cpu(x, torch.tensor(481.0), ctx)
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  UNet 32x32 (bf16 kernels on the card vs fp32 plain on the CPU, "
        f"{time.perf_counter() - t0:.1f} s): relative L2 error {rel:.3e} (tol 5e-2)")
    if not (torch.isfinite(got).all() and rel < 5e-2):
        raise AssertionError(f"UNet card-vs-CPU relative error {rel}")


# how many kernels one call of each wrapper launches, by kernel family (the
# taxonomy is utils/traceparse.py's). The wgmma core's bodies are kernels of
# their own: attn_sm90_online (mode 2, _kernel), attn_sm90_two_pass and
# attn_sm90_short; flash_mha_eod alone launches the d-major two-pass body
# (DMAJOR = true).
KERNELS_PER_CALL = {"sd_or_step": ("sd_or_step", 1), "flash_mha_eod": (EOD, 1),
                    "geglu_ffn_block": ("geglu_ffn_block", 3), "_kernel": (ONLINE, 1),
                    "_kernel_mh": (ATTN_OTHER, 1), "fused_sde_step": ("fused_sde_step", 1)}


def device_kernels(events):
    """(family, kernel name, device ms, launches) of each kernel a profile's
    ``key_averages()`` holds (not the ops or the step's range, which repeat
    their kernels' time, nor runtime calls and buffers)."""
    from torch.autograd import DeviceType

    for e in events:
        us = e.self_device_time_total
        if (us <= 0 or e.device_type != DeviceType.CUDA
                or e.key.startswith(("aten::", "cuda", "Activity Buffer", "Buffer Flush",
                                     "ProfilerStep"))):
            continue
        yield family(e.key), e.key, us / 1e3, e.count


def recorded_kernels(prof):
    """:func:`device_kernels` of one recorded profiler cycle (``prof`` as
    ``on_trace_ready`` gets it), without the kernel records that started
    before the cycle's recorded step began. The tracer now and then hands a
    cycle the last kernel of the unrecorded run before it, synchronized
    before the step began, and ``key_averages()`` keeps it: such a
    ``fused_sde_step`` record made a recorded 10-step CIFAR run count 11
    launches (``scripts/torch_profile_records.py`` lists these records).
    Without the host's activity (``cpu=False``) no step marks the start,
    and every record is kept."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    events = prof.events()
    begin = min((e.time_range.start for e in events if e.name.startswith("ProfilerStep")),
                default=-math.inf)
    by_key = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.time_range.start < begin:
            continue
        r = by_key.setdefault(e.key, SimpleNamespace(
            key=e.key, device_type=e.device_type, self_device_time_total=0.0, count=0))
        r.self_device_time_total += e.self_device_time_total
        r.count += 1
    return list(device_kernels(by_key.values()))


def expect_profiled_launches(what, counts, steps, **calls):
    """The launches a profiled run of ``steps`` captured steps replayed, by
    kernel family, against ``calls`` wrapper calls per step (a family that
    two wrappers share adds both): the kernel names the trace holds, not
    the wrappers' counters, which a replay never touches."""
    want = {}
    for name, n in calls.items():
        fam, per_call = KERNELS_PER_CALL[name]
        want[fam] = want.get(fam, 0) + n * per_call * steps
    got = {fam: counts.get(fam, 0) for fam in want}
    log(f"  {what}: kernels per step from the profiler: " + ", ".join(
        f"{fam} {n / steps:g}" for fam, n in got.items()) + " (wrapper calls per step: " +
        ", ".join(f"{k} {v}" for k, v in calls.items()) + ")")
    if got != want:
        raise AssertionError(f"{what}: profiled launches {got} != {want}")


def profile_step(sampler, ctxs, dev, steps):
    """Device time and launches by kernel family over one run of a captured
    sampler (its graph already built) of ``steps`` steps (torch.profiler),
    per step, and the device's idle share; the table goes to
    chip_smoke_profile.txt in the output directory."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    float(sampler(*ctxs, generator=gen)[0].sum())  # its graph, if another run replaced it
    fams, wall, counts = profile_by_family(lambda: sampler(*ctxs, generator=gen), OUT /
                                           "chip_smoke_profile.txt")
    total = sum(fams.values())
    log(f"  profile (one captured 512 px or run, {steps} steps): {total / steps:.3f} ms device "
        f"time per step, {wall / steps:.3f} ms wall per step under the profiler (device idle "
        f"{1 - total / wall:.3f}); per step by family (ms): " +
        ", ".join(f"{k} {v / steps:.4f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])))
    expect_profiled_launches("captured 512 px or", counts, steps, sd_or_step=1,
                             flash_mha_eod=10, geglu_ffn_block=16)


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


def agreed(runs):
    """{family: kernels} that recorded runs agree on: the median over an odd
    count of runs. The tracer loses a kernel record now and then (one
    ``fused_sde_step`` record of ten, in one of six repeated profiles) and
    now and then hands a run one more (11 ``fused_sde_step`` records for a
    10-step CIFAR run, in one of three), so one run alone can miscount
    either way, and the most or the fewest of several too."""
    import statistics

    if len(runs) % 2 == 0:
        raise ValueError(f"agreed: an odd count of recorded runs, not {len(runs)}")
    fams = {fam for r in runs for fam in r}
    return {fam: statistics.median(r.get(fam, 0) for r in runs) for fam in fams}


def counted_runs(what, run, steps, cycles=3, **calls):
    """Launches on the device, by kernel wrapper, of a path's captured run
    as a user's first call makes it (``run()`` starts from no kept loop:
    step 0 eagerly, the capture, which records and runs nothing, and the
    other ``steps - 1`` steps replayed). ``run()`` is recorded ``cycles``
    times under torch.profiler, each after an unrecorded run while the
    tracer warms up, with every count set to 0 just before and read just
    after: the wrappers must count 2 per per-step call (step 0 and the
    capture) and no other kernel. The launches are the kernels of each
    wrapper's family that the trace shows starting inside the recorded run
    (:func:`recorded_kernels`), the median of the recorded runs
    (:func:`agreed`), over its kernels per call; they must be
    ``calls[name]`` a step over ``steps`` steps. Returns {wrapper:
    launches}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=cycles),
                 on_trace_ready=lambda p: traced.append(recorded_kernels(p))) as prof:
        for _ in range(cycles):
            run()
            torch.cuda.synchronize()
            prof.step()
            zero_counts()
            run()
            torch.cuda.synchronize()
            expect_counts(f"{what} (wrapper calls: step 0 and the capture)", read_counts(),
                          **{k: 2 * v for k, v in calls.items()})
            prof.step()
    runs = []
    for kernels in traced:
        seen = {}
        for fam, _, _, n in kernels:
            seen[fam] = seen.get(fam, 0) + n
        runs.append(seen)
    most = agreed(runs)
    got = {name: most.get(KERNELS_PER_CALL[name][0], 0) // KERNELS_PER_CALL[name][1]
           for name in calls}
    log(f"  {what}: launches on the device (profiler, the median of {cycles} runs): " +
        ", ".join(f"{k} {v}" for k, v in got.items()) + f" over {steps} steps")
    if got != {name: n * steps for name, n in calls.items()}:
        raise AssertionError(f"{what}: launches {got}, want {calls} a step over {steps}")
    return got


def profile_by_family(run, path, cycles=3, cpu=True, warmup=1):
    """Device time of ``run()`` by kernel family (torch.profiler); the table
    goes to ``path``. ``run()`` is recorded ``cycles`` times, each after
    ``warmup`` unrecorded runs while the tracer warms up; ``cpu=False`` records the
    card's activity alone, not the host's op events. Returns ({family: ms}, wall ms
    under the profiler) of the first recorded run, and {family: kernels
    launched}, the median of the recorded runs (:func:`agreed`), each run's
    kernels those that started inside it (:func:`recorded_kernels`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced, walls = [], []
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=warmup, active=1, repeat=cycles),
                 on_trace_ready=lambda p: traced.append((p.key_averages(),
                                                         recorded_kernels(p)))) as prof:
        for _ in range(cycles):
            for _ in range(warmup):
                run()
                torch.cuda.synchronize()
                prof.step()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            prof.step()
    path.write_text(traced[0][0].table(sort_by="self_device_time_total", row_limit=60))
    runs = []
    for _, kernels in traced:
        totals, counts = {}, {}
        for fam, _, ms, n in kernels:
            totals[fam] = totals.get(fam, 0.0) + ms
            counts[fam] = counts.get(fam, 0) + n
        runs.append((totals, counts))
    return runs[0][0], walls[0], agreed([c for _, c in runs])


def cifar_phase(dev, args):
    """The CIFAR joint sampler at full width (``vpsdeA``: nf 128, ch_mult
    (1,2,2,2), attention at 16 and 8, 10 classes), two models with drawn
    non-zero weights, batch 100, labels tiled 0-9, bf16 compute: the SDE /
    OR trajectory captured (the counted run) and eager, the captured run
    held bit for bit to the eager one, both timed in turns; then the ODE.
    Returns the models, the config and the labels."""
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
    warm = cifar.make_generator(models, cfg, n_steps=2, labels=labels, capture=False)
    for _ in range(2):  # two synced warmups
        float(warm(torch.Generator(device=dev).manual_seed(0))[0].sum())
    steps = args.cifar_steps
    captured = lambda: cifar.make_generator(models, cfg, mode="sde", operator="or",
                                            n_steps=steps, labels=labels, capture=True)
    generate = captured()
    eager = cifar.make_generator(models, cfg, mode="sde", operator="or", n_steps=steps,
                                 labels=labels, capture=False)
    gen = lambda: torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_sde_step.launches = 0
    t0 = time.perf_counter()
    x0, logq = generate(gen())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_sde_step.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    # captured: the eager step 0 and the capture of one step
    log(f"  generate (sde, or, {steps} steps, batch {b}, captured; the first call, with its "
        f"eager step 0 and the capture): {wall:.3f} s wall, peak memory {peak:.3f} GiB; "
        f"fused_sde_step wrapper calls {launches} (want 2: step 0 and the capture)")
    if launches != 2:
        raise AssertionError(f"fused_sde_step launches {launches} != 2")
    fused_sde_step.launches = 0
    ex0, elogq = eager(gen())
    torch.cuda.synchronize()
    log(f"  eager twin: fused_sde_step launches {fused_sde_step.launches} (want {steps}); "
        f"x0 {'bit-identical' if torch.equal(x0, ex0) else 'DIFFERS'} to the captured run's "
        f"(max abs {(x0 - ex0).abs().max().item():.3e}), logq "
        f"{'bit-identical' if torch.equal(logq, elogq) else 'DIFFERS'} "
        f"(max abs {(logq - elogq).abs().max().item():.3e})")
    if fused_sde_step.launches != steps:
        raise AssertionError(f"eager fused_sde_step launches {fused_sde_step.launches} != "
                             f"{steps}")
    if not (torch.equal(x0, ex0) and torch.equal(logq, elogq)):
        raise AssertionError("CIFAR: the captured run differs from the eager one")
    kept = [generate]  # the generator keeps its captured loop: a new one drops it
    t = captured_and_eager(lambda: kept[0](gen()), lambda: eager(gen()), steps,
                           lambda: kept.__setitem__(0, captured()))
    log(f"  sampler (sde, or, {steps} steps, batch {b}): captured {t['captured']:.3f} ms per "
        f"step ({b / (t['captured'] * steps / 1e3):.3f} images/s), eager {t['eager']:.3f} ms "
        f"per step ({b / (t['eager'] * steps / 1e3):.3f} images/s) (medians in turns: "
        f"captured {[round(v, 3) for v in t['all']['captured']]}, eager "
        f"{[round(v, 3) for v in t['all']['eager']]}; the first call, with its eager step 0 "
        f"and the capture, {t['first']:.3f} ms per step); peak memory captured "
        f"{t['peak_captured'] - base / 2**30:.3f} GiB, eager {t['peak_eager'] - base / 2**30:.3f}"
        f" GiB above the earlier phases' {base / 2**30:.3f}")
    del eager, ex0, elogq
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
    return models, cfg, labels


def cifar_counted_run(models, cfg, labels, dev, steps=10):
    """The CIFAR SDE/OR path's launches on the device: a new generator's
    first call of ``steps`` steps (step 0 eagerly, the capture, the other
    steps replayed), read from the profiler (:func:`counted_runs`)."""
    import torch

    from superdiff_tpu_torch.pipelines import cifar

    run = lambda: cifar.make_generator(models, cfg, n_steps=steps, labels=labels)(
        torch.Generator(device=dev).manual_seed(3))
    return counted_runs(f"CIFAR sde/or, generate, {steps} steps", run, steps,
                        fused_sde_step=1)


def cifar_profile(models, cfg, labels, dev):
    """10 captured CIFAR SDE/OR steps (the graph built before) under
    torch.profiler: device time and launches by kernel family, and the
    device's idle share in that same run."""
    import torch

    from superdiff_tpu_torch.pipelines import cifar

    short = cifar.make_generator(models, cfg, n_steps=10, labels=labels, capture=True)
    gen = lambda: torch.Generator(device=dev).manual_seed(2)
    float(short(gen())[0].sum())  # its first call: step 0 and the capture
    fams, wall, counts = profile_by_family(
        lambda: short(gen()), OUT / "chip_smoke_cifar_profile.txt")
    total = sum(fams.values())
    log(f"  profile (10 captured sde/or steps): {total / 10:.3f} ms device time per step, "
        f"{wall / 10:.3f} ms wall per step under the profiler (device idle "
        f"{1 - total / wall:.3f}); by family (ms per step): " + ", ".join(
            f"{k} {v / 10:.4f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])))
    expect_profiled_launches("captured CIFAR sde/or", counts, 10, fused_sde_step=1)


def kernel_wrappers():
    """{row name: (object holding the count, key or None)} for every kernel."""
    from superdiff_tpu_torch.ops import flash_attention as fa
    from superdiff_tpu_torch.ops import fused_step, geglu_ffn, sd_fused_step

    rows = {"sd_or_step": (sd_fused_step.sd_or_step, None),
            "flash_mha_eod": (fa.flash_mha_eod, None),
            "fused_sde_step": (fused_step.fused_sde_step, None)}
    # one count per configuration of the FFN kernel, keyed by gelu flavour
    rows.update({name: ((geglu_ffn.geglu_ffn_block if fused else geglu_ffn.geglu_ffn).launches,
                        "tanh" if tanh else "erf") for name, fused, tanh in GEGLU_CONFIGS})
    rows.update({name: (fa.flash_mha_bhld.launches, name) for name in BHLD_KERNELS})
    return rows


def zero_counts():
    for holder, key in kernel_wrappers().values():
        if key is None:
            holder.launches = 0
        else:
            holder[key] = 0


def read_counts():
    return {name: (holder.launches if key is None else holder[key])
            for name, (holder, key) in kernel_wrappers().items()}


def expect_counts(what, got, **want):
    """Every kernel's count over one run: those named in ``want`` exactly,
    every other 0."""
    want = {name: want.get(name, 0) for name in got}
    log(f"  {what}: launches " + ", ".join(f"{k} {v}" for k, v in got.items() if v or want[k]))
    if got != want:
        raise AssertionError(f"{what}: launch counts {got} != {want}")


def with_attn_impl(sd, mod, impl, **changes):
    """``mod`` with its UNet behind another ``attn_impl`` (and any other
    config ``changes``, such as ``ffn_impl``): the same parameter tensors
    (assigned, not copied), so the same weights."""
    import dataclasses

    import torch

    with torch.device("meta"):
        unet = sd.SDUNet(dataclasses.replace(mod.unet.config, attn_impl=impl, **changes),
                         dtype=mod.unet.dtype)
    unet.load_state_dict(mod.unet.state_dict(), assign=True)
    # the non-persistent buffers (timestep frequencies, upsampler taps) are
    # not in the state dict: the same tensors too
    for name, buf in mod.unet.named_buffers(remove_duplicate=False):
        owner, _, leaf = name.rpartition(".")
        unet.get_submodule(owner).register_buffer(leaf, buf, persistent=False)
    return dataclasses.replace(mod, unet=unet.eval().requires_grad_(False))


def eager_generate(sd, *args, **kwargs):
    """``sd.generate`` with every step run eagerly: the lever phases count
    each launch with the wrappers' counters, which a graph replay does not
    touch."""
    return sd.generate(*args, capture=False, **kwargs)


def counted_generate(sd, mod, method, cfg, batch, seed, decode=False, capture=False):
    """One ``generate`` with every count set to 0 just before and read just
    after; returns (output, counts, wall seconds). Captured, the run starts
    from no kept loop, and its counts are those of the eager step 0 and of
    the capture (a replay counts nothing)."""
    import torch

    mod.or_loop = None
    zero_counts()
    t0 = time.perf_counter()
    out = sd.generate(mod, method, *PROMPTS, seed=seed, batch_size=batch, cfg=cfg,
                      decode=decode, capture=capture)
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0


def same_run(what, got, ref, keys=("kappa", "ll_obj", "ll_bg")):
    """Hold a captured SD run to its eager twin bit for bit: the latents
    and the traces ``keys``."""
    import torch

    pairs = [("latents", got["latents"], ref["latents"])]
    pairs += [(k, got["traces"][k], ref["traces"][k]) for k in keys]
    diff = {k: (a - b).abs().max().item() for k, a, b in pairs}
    log(f"  {what}: captured against eager on the same noise: " + ", ".join(
        f"{k} {'bit-identical' if torch.equal(a, b) else f'max abs {diff[k]:.3e}'}"
        for k, a, b in pairs))
    if not all(torch.equal(a, b) for _, a, b in pairs):
        raise AssertionError(f"{what}: the captured run differs from the eager one: {diff}")


def captured_and_eager(run_captured, run_eager, steps, drop, rounds=2):
    """Per-step ms of a captured sampler and its eager twin, timed in turns
    (captured, eager, eager, captured per round; host clock around synced
    runs), after the captured sampler's first call (``drop()`` forgets its
    kept loop first: step 0 eagerly, the capture and the other steps
    replayed, timed apart). Returns {"first", "captured", "eager": median
    ms per step, "peak_captured", "peak_eager": GiB}."""
    import statistics

    import torch

    def timed(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / steps,
                torch.cuda.max_memory_allocated() / 2**30)

    drop()
    first, peak_c = timed(run_captured)
    times = {"captured": [], "eager": []}
    peaks = {"captured": peak_c, "eager": 0.0}
    for _ in range(rounds):
        for which, run in (("captured", run_captured), ("eager", run_eager),
                           ("eager", run_eager), ("captured", run_captured)):
            ms, peak = timed(run)
            times[which].append(ms)
            peaks[which] = max(peaks[which], peak)
    return {"first": first, **{k: statistics.median(v) for k, v in times.items()},
            "all": times, "peak_captured": peaks["captured"], "peak_eager": peaks["eager"]}


def sd_captured_and_eager(sd, mod, cfg, batch, seed, dev, what):
    """Time SD ``or`` captured and eager in turns on ready contexts; returns
    the captured sampler, whose graph is built, and its contexts."""
    import torch

    ctxs = sd.prepare_contexts(mod, "or", *PROMPTS, batch)
    captured = sd.make_sampler(mod, "or", cfg, capture=True)
    eager = sd.make_sampler(mod, "or", cfg, capture=False)
    gen = lambda: torch.Generator(device=dev).manual_seed(seed)
    t = captured_and_eager(lambda: captured(*ctxs, generator=gen()),
                           lambda: eager(*ctxs, generator=gen()), cfg.num_inference_steps,
                           lambda: setattr(mod, "or_loop", None))
    log(f"  {what}: captured {t['captured']:.3f} ms per step, eager {t['eager']:.3f} "
        f"(medians in turns: captured {[round(v, 3) for v in t['all']['captured']]}, eager "
        f"{[round(v, 3) for v in t['all']['eager']]}; the captured sampler's first call, "
        f"with its eager step 0 and the capture, {t['first']:.3f} ms per step); peak memory "
        f"captured {t['peak_captured']:.2f} GiB, eager {t['peak_eager']:.2f} GiB")
    return captured, ctxs


def generate_in_turns(sd, mod, seed, steps):
    """``generate`` of ``steps`` steps at 512 px, latent batch 8, no decode,
    as a user calls it: captured as a first call (no kept loop: step 0
    eagerly, the capture, the other steps replayed), captured again (the
    kept loop: every step replayed) and eager, in turns (first, eager, kept,
    kept, eager, first; host clock around synced calls). Prints each one's
    seconds and ms per step; the three give the same latents bit for
    bit."""
    import statistics

    import torch

    cfg = sd.SDPipelineConfig(num_inference_steps=steps)
    times, outs = {"first": [], "kept": [], "eager": []}, {}
    for which in ("first", "eager", "kept", "kept", "eager", "first"):
        if which == "first":
            mod.or_loop = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sd.generate(mod, "or", *PROMPTS, seed=seed, batch_size=8, cfg=cfg, decode=False,
                          capture=False if which == "eager" else None)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
        outs[which] = out["latents"]
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"  generate, {steps} steps, in turns: " + "; ".join(
        f"{k} {med[k]:.4f} s ({med[k] * 1e3 / steps:.3f} ms per step; "
        f"{', '.join(f'{v:.4f}' for v in times[k])} s)" for k in times))
    if not (torch.equal(outs["first"], outs["eager"]) and torch.equal(outs["kept"], outs["eager"])):
        raise AssertionError(f"generate, {steps} steps: captured latents differ from eager")


def timed_sampler(sd, mod, method, cfg, batch, seed, dev):
    """(ms per step, peak GiB) of one synced eager sampler run on ready
    contexts."""
    import torch

    ctxs = sd.prepare_contexts(mod, method, *PROMPTS, batch)
    sampler = sd.make_sampler(mod, method, cfg, capture=False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, _ = sampler(*ctxs, generator=gen)
    float(x.sum())
    ms = (time.perf_counter() - t0) * 1e3 / cfg.num_inference_steps
    return ms, torch.cuda.max_memory_allocated() / 2**30


def finite(what, *tensors):
    import torch

    for t in tensors:
        if not torch.isfinite(t).all():
            raise AssertionError(f"{what}: not finite")


def sd_768_phase(sd, mod, args, dev):
    """SD ``or`` at 768 px, latent batch 8, default ``attn_impl``: the
    9216-token rows reach the online-softmax kernel, the 2304-token rows the
    d-major kernel, the 576-token rows (head dim 160) ``_kernel_mh``. Run
    captured and eager: the counts of each run, the captured run held bit
    for bit to the eager one, both timed in turns. Then one step at 1024 px
    the same way."""
    import torch

    one = sd.SDPipelineConfig(num_inference_steps=1, height=768, width=768)
    cfg = sd.SDPipelineConfig(num_inference_steps=2, height=768, width=768)
    for _ in range(2):  # two synced warmups
        float(eager_generate(sd, mod, "or", *PROMPTS, seed=args.seed, batch_size=8, cfg=one,
                             decode=False)["latents"].sum())
    out, counts, wall = counted_generate(sd, mod, "or", cfg, 8, args.seed, decode=True,
                                         capture=True)
    # captured: the eager step 0 and the capture of one step
    expect_counts("768 px or, captured (step 0 + capture)", counts, sd_or_step=2,
                  flash_mha_eod=10, geglu_ffn_block=32, _kernel=10, _kernel_mh=10)
    eager, eager_counts, _ = counted_generate(sd, mod, "or", cfg, 8, args.seed)
    expect_counts("768 px or, eager, 2 steps", eager_counts, sd_or_step=2, flash_mha_eod=10,
                  geglu_ffn_block=32, _kernel=10, _kernel_mh=10)
    same_run("768 px or, 2 steps", out, eager)
    lat, kappa, img = out["latents"], out["traces"]["kappa"], out["images"]
    finite("768 px latents", lat)
    if lat.shape != (8, 96, 96, 4) or not ((kappa >= 0) & (kappa <= 1)).all():
        raise AssertionError(f"768 px: latents {tuple(lat.shape)}, kappa {kappa}")
    if img.dtype != torch.uint8 or img.shape != (8, 768, 768, 3):
        raise AssertionError(f"768 px images {img.dtype} {tuple(img.shape)}")
    log(f"  generate: {wall:.3f} s wall; latents |x|max {lat.abs().max().item():.4f}; kappa "
        f"last step {[round(v, 6) for v in kappa[-1].tolist()]}; images {tuple(img.shape)} "
        f"uint8 mean {img.float().mean().item():.3f}")
    del out, eager, lat, img
    torch.cuda.empty_cache()
    sd_captured_and_eager(sd, mod, cfg, 8, args.seed, dev, "768 px sampler (2 steps)")
    torch.cuda.empty_cache()

    # one step at 1024 px: 16384-token rows (4 kv blocks of 4096) in the
    # online-softmax kernel, 4096- and 1024-token rows (head dims 80 and 160)
    # in the d-major kernel
    big = sd.SDPipelineConfig(num_inference_steps=1, height=1024, width=1024)
    float(eager_generate(sd, mod, "or", *PROMPTS, seed=args.seed, batch_size=8, cfg=big,
                         decode=False)["latents"].sum())
    out, big_counts, _ = counted_generate(sd, mod, "or", big, 8, args.seed, capture=True)
    expect_counts("1024 px or, captured (step 0 + capture)", big_counts, sd_or_step=2,
                  flash_mha_eod=20, geglu_ffn_block=32, _kernel=10)
    eager, eager_counts, _ = counted_generate(sd, mod, "or", big, 8, args.seed)
    expect_counts("1024 px or, eager, 1 step", eager_counts, sd_or_step=1, flash_mha_eod=10,
                  geglu_ffn_block=16, _kernel=5)
    same_run("1024 px or, 1 step", out, eager)
    finite("1024 px latents", out["latents"])
    if out["latents"].shape != (8, 128, 128, 4):
        raise AssertionError(f"1024 px latents {tuple(out['latents'].shape)}")
    del out, eager
    torch.cuda.empty_cache()
    sd_captured_and_eager(sd, mod, big, 8, args.seed, dev, "1024 px sampler (1 step)")
    torch.cuda.empty_cache()


def sd_attn_impl_phase(sd, mod, args, dev):
    """SD ``or`` at 512 px under ``attn_impl="flash_eo"`` (2 steps), then one
    step under every other ``_LONG_IMPL`` name and one under
    ``attn_impl="flash"``. Returns the launches counted under each kernel
    name."""
    import torch

    from superdiff_tpu_torch.ops import flash_attention as fa

    eo = with_attn_impl(sd, mod, "flash_eo")
    one = sd.SDPipelineConfig(num_inference_steps=1)
    two = sd.SDPipelineConfig(num_inference_steps=2)
    float(eager_generate(sd, eo, "or", *PROMPTS, seed=args.seed, batch_size=8, cfg=one,
                         decode=False)["latents"].sum())
    out, counts, _ = counted_generate(sd, eo, "or", two, 8, args.seed)
    expect_counts("flash_eo, pvt1, 2 steps", counts, sd_or_step=2, geglu_ffn_block=32,
                  _make_pvt_kernel=10, _kernel_mh=10)
    finite("flash_eo latents", out["latents"])
    launches = {"_make_pvt_kernel": counts["_make_pvt_kernel"]}
    ms, peak = timed_sampler(sd, eo, "or", two, 8, args.seed, dev)
    log(f"  flash_eo sampler: {ms:.3f} ms per step, peak memory {peak:.2f} GiB")

    lat = {}
    for impl in ("pvt1", "pvt1", "1block", "mxsum", "pipe2", "pipe4", "pvt2", "pvt4"):
        fa._LONG_IMPL = impl
        out, counts, _ = counted_generate(sd, eo, "or", one, 8, args.seed)
        fa._LONG_IMPL = "pvt1"
        name = fa._LONG_KERNELS[impl][0]
        expect_counts(f"flash_eo, {impl}, 1 step", counts, sd_or_step=1, geglu_ffn_block=16,
                      _kernel_mh=5, **{name: 5})
        finite(f"flash_eo {impl} latents", out["latents"])
        if impl == "pvt1" and impl in lat:
            repeatable = torch.equal(lat[impl], out["latents"])
        elif impl != "pvt1":
            launches[name] = launches.get(name, 0) + counts[name]
        lat[impl] = out["latents"]
    scale = lat["pvt1"].abs().max().item()
    diff = {k: (v - lat["pvt1"]).abs().max().item() for k, v in lat.items()}
    log(f"  one step, latents against pvt1's (|x|max {scale:.4f}; a repeated pvt1 run is "
        f"{'' if repeatable else 'NOT '}bit-identical): " +
        ", ".join(f"{k} {v:.3e}" for k, v in diff.items()))
    for k, v in diff.items():
        # one kernel on one input under every bf16-sum name: equal bit for
        # bit, as far as the libraries around it repeat themselves. 1block
        # sums the fp32 p instead: below the bf16 grid of an attention
        # output, but it flips some roundings by one bf16 ulp (2^-8), which
        # the bf16 UNet carries on like its own rounding noise (its forward
        # is held to 5e-2 of its fp32 self): 1e-2 of the largest latent
        if v > (1e-2 * scale if k == "1block" or not repeatable else 0.0):
            raise AssertionError(f"flash_eo under {k} differs from pvt1 by {v}")

    fl = with_attn_impl(sd, mod, "flash")
    out, counts, _ = counted_generate(sd, fl, "or", one, 8, args.seed)
    expect_counts("flash, pvt1, 1 step", counts, sd_or_step=1, geglu_ffn_block=16,
                  _kernel_mh=5, _make_pvt_kernel=5)
    d = (out["latents"] - lat["pvt1"]).abs().max().item()
    log(f"  flash against flash_eo under pvt1: max abs difference {d:.3e} "
        f"(tol {1e-2 * scale:.3e}: the same kernels on the same values in another layout)")
    if not d <= 1e-2 * scale:
        raise AssertionError(f"flash differs from flash_eo by {d}")
    return launches


def sd_methods_phase(sd, mod, args, dev):
    """The other methods at 512 px, default config: ``and``, ``avg`` (2
    steps), ``avg_ode``, ``sd_a`` (1 step) at latent batch 8; ``and_ode`` (one
    ``torch.func.jvp`` through the bf16 UNet, every kernel's tangent through
    its plain version) at latent batch 2, beside an ``or`` step of that
    batch."""
    import torch

    one = sd.SDPipelineConfig(num_inference_steps=1)
    two = sd.SDPipelineConfig(num_inference_steps=2)
    for method, cfg in (("and", two), ("avg", two), ("avg_ode", one), ("sd_a", one)):
        n = cfg.num_inference_steps
        out, counts, wall = counted_generate(sd, mod, method, cfg, 8, args.seed)
        expect_counts(f"{method}, {n} steps", counts, flash_mha_eod=10 * n,
                      geglu_ffn_block=16 * n)
        tr = out["traces"]
        finite(method, out["latents"], tr["kappa"], tr["ll_obj"], tr["ll_bg"],
               tr["final_ll_uncond"])
        if method.startswith("avg") and not torch.all(tr["kappa"] == cfg.kappa_fixed):
            raise AssertionError(f"{method}: kappa {tr['kappa']} != {cfg.kappa_fixed}")
        if (method == "sd_a") != bool((tr["final_ll_uncond"] != 1.0).all()):
            raise AssertionError(f"{method}: final_ll_uncond {tr['final_ll_uncond']}")
        log(f"  {method}: {wall * 1e3 / n:.1f} ms per step with the text encoder; |x|max "
            f"{out['latents'].abs().max().item():.4f}; kappa last step "
            f"{[round(v, 4) for v in tr['kappa'][-1].tolist()]}; final_ll_uncond[0] "
            f"{tr['final_ll_uncond'][0].item():.4f}")
    times = {}
    for method in ("or", "and_ode"):
        float(eager_generate(sd, mod, method, *PROMPTS, seed=args.seed, batch_size=2,
                             cfg=one, decode=False)["latents"].sum())  # warmup
        ms, peak = timed_sampler(sd, mod, method, one, 2, args.seed, dev)
        times[method] = ms
        log(f"  {method}, latent batch 2, 1 step after a 1-step warmup: {ms:.3f} ms, "
            f"peak memory {peak:.2f} GiB")
    out, counts, _ = counted_generate(sd, mod, "and_ode", one, 2, args.seed)
    expect_counts("and_ode, 1 step", counts, flash_mha_eod=10, geglu_ffn_block=16)
    finite("and_ode", out["latents"], out["traces"]["kappa"], out["traces"]["ll_obj"])
    log(f"  and_ode / or step: {times['and_ode'] / times['or']:.2f}x; kappa "
        f"{[round(v, 4) for v in out['traces']['kappa'][-1].tolist()]}")


def sd_packed_phase(sd, mod, args, dev):
    """The packed-layout paths at 512 px, latent batch 8: ``attn_impl=
    "flash_nat"`` (2 counted steps, then a timed run), one step each under
    ``_CROSS_IMPL="xpk"`` and ``"nat"`` with the default ``attn_impl``, and
    one 768 px step under ``flash_nat``. Returns the launches of the kernels'
    own paths (``flash_nat`` for ``_kernel_mh_nat``, ``xpk`` for
    ``_kernel_cross_packed``).

    Held, where the comparison is well conditioned: one step's latents
    within 1e-2 of the largest latent of the same path with every
    packed-layout kernel replaced by its plain version (which phase 2 holds
    the kernels to at every shape), and of the default path on the same seed
    and weights (another rounding of each attention row, which the bf16 UNet
    carries on like its own noise, as ``1block`` in phase 3c); one UNet
    forward within 5e-2 relative L2 of the same with the plain versions, the
    bound phase 5 holds the bf16 UNet to against fp32. Printed beside it: the
    forward's distance to the default path and to ``flash_eo`` under
    ``1block`` against ``pvt1`` (what one bf16 ulp in some attention outputs
    does to this randomly weighted forward); and two steps, whose second
    step (sigma 0.029 to 0, guidance 7.5 on two large, nearly equal
    velocities) magnifies any rounding, as ``1block`` against ``pvt1`` shows
    there too."""
    import torch

    from superdiff_tpu_torch.ops import flash_attention as fa

    def with_lever(lever, fn):
        fa._CROSS_IMPL = lever
        try:
            return fn()
        finally:
            fa._CROSS_IMPL = "einsum"

    def swapped(name, stand_in, fn):
        """``fn()`` with ``fa.<name>`` replaced by ``stand_in``."""
        real = getattr(fa, name)
        setattr(fa, name, stand_in)
        try:
            return fn()
        finally:
            setattr(fa, name, real)

    def plain_launch(q, k, v, sm_scale, name):
        return torch.cat([fa._plain(name, *(a[i:i + 1].transpose(1, 2) for a in (q, k, v)),
                                    sm_scale, None, None).transpose(1, 2)
                          for i in range(q.shape[0])])

    def reference_fp32_logits(q, k, v, sm_scale):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v)

    def latents(m, cfg, lever="einsum", plain=False):
        run = lambda: with_lever(lever, lambda: eager_generate(
            sd, m, "or", *PROMPTS, seed=args.seed, batch_size=8, cfg=cfg, decode=False))
        out = swapped("_launch_packed", plain_launch, run) if plain else run()
        return out["latents"]

    def dist(a, b):
        return (a - b).abs().max().item()

    def map_cache(what, run):
        """``run()``, logging the tensor maps the launches in it found in the
        libraries' caches (hits) or encoded (misses)."""
        before = fa.map_cache_stats()
        result = run()
        after = fa.map_cache_stats()
        log(f"  tensor-map cache over {what}: " + ", ".join(
            f"{lib} {after[lib][0] - before[lib][0]} hits / {after[lib][1] - before[lib][1]} "
            f"misses" for lib in after))
        return result

    ctx = torch.cat(sd.prepare_contexts(mod, "or", *PROMPTS, 8))
    eo = with_attn_impl(sd, mod, "flash_eo")
    asserts = []

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def forward_check(what, m, hw, lever="einsum"):
        g = torch.Generator(device=dev).manual_seed(args.seed)
        x = torch.randn(8, hw // 8, hw // 8, 4, device=dev, generator=g)
        t = torch.tensor(999.0)
        with torch.no_grad():
            run = lambda: with_lever(lever, lambda: m.unet(x, t, ctx))
            got, plain, default = run(), swapped("_launch_packed", plain_launch, run), mod.unet(
                x, t, ctx)
            fa._LONG_IMPL = "1block"
            one_block = eo.unet(x, t, ctx)
            fa._LONG_IMPL = "pvt1"
            noise = rel(one_block, eo.unet(x, t, ctx))
        r = rel(got, plain)
        log(f"  {what}, one UNet forward: relative L2 {r:.3e} against the same with the "
            f"kernels' plain versions (tol 5e-2), {rel(got, default):.3e} against the default "
            f"path; flash_eo under 1block {noise:.3e} against pvt1")
        asserts.append((f"{what} forward", r, 5e-2))

    def step_check(what, out, m, cfg, lever="einsum", hold=True):
        lat, kappa = out["latents"], out["traces"]["kappa"]
        finite(what, lat, kappa)
        if not ((kappa >= 0) & (kappa <= 1)).all():
            raise AssertionError(f"{what}: kappa {kappa}")
        plain, default = latents(m, cfg, lever, plain=True), latents(mod, cfg)
        scale = plain.abs().max().item()
        d, d_default = dist(lat, plain), dist(lat, default)
        log(f"  {what}: latents against the same path with the kernels' plain versions: "
            f"max abs difference {d:.3e}, against the default path's {d_default:.3e}, of "
            f"|x|max {scale:.4f}" + (f" (tol {1e-2 * scale:.3e})" if hold else " (printed)")
            + f"; kappa last step {[round(v, 6) for v in kappa[-1].tolist()]}")
        if hold:
            asserts.append((what, d, 1e-2 * scale))
            asserts.append((f"{what}, against the default path", d_default,
                            1e-2 * default.abs().max().item()))
        return default

    one = sd.SDPipelineConfig(num_inference_steps=1)
    two = sd.SDPipelineConfig(num_inference_steps=2)
    nat = with_attn_impl(sd, mod, "flash_nat")
    float(latents(nat, one).sum())  # warmup
    out, counts, _ = counted_generate(sd, nat, "or", two, 8, args.seed)
    expect_counts("flash_nat, 2 steps", counts, sd_or_step=2, geglu_ffn_block=32,
                  _kernel_mh_nat=64)
    launches = {"_kernel_mh_nat": counts["_kernel_mh_nat"]}
    default = step_check("flash_nat, 2 steps", out, nat, two, hold=False)
    fp32 = swapped("_reference", reference_fp32_logits, lambda: latents(mod, two))
    fa._LONG_IMPL = "1block"
    one_block = latents(eo, two)
    fa._LONG_IMPL = "pvt1"
    log(f"  2 steps, how far roundings alone move the latents: the default path with fp32 "
        f"logits in its plain short-row attention {dist(fp32, default):.3e} from the default "
        f"path and {dist(fp32, out['latents']):.3e} from flash_nat; flash_eo under 1block "
        f"{dist(one_block, latents(eo, two)):.3e} from pvt1 (one bf16 ulp in the long rows' "
        f"row sums)")
    out, counts, _ = map_cache("flash_nat, one 1-step generate (after 3 steps)",
                               lambda: counted_generate(sd, nat, "or", one, 8, args.seed))
    expect_counts("flash_nat, 1 step", counts, sd_or_step=1, geglu_ffn_block=16,
                  _kernel_mh_nat=32)
    step_check("flash_nat, 1 step", out, nat, one)
    forward_check("flash_nat, 512 px", nat, one.height)
    cfg = sd.SDPipelineConfig(num_inference_steps=args.steps)
    ms, peak = map_cache(f"the flash_nat sampler's {args.steps} steps",
                         lambda: timed_sampler(sd, nat, "or", cfg, 8, args.seed, dev))
    log(f"  flash_nat sampler: {ms:.3f} ms per step ({args.steps} steps), peak memory "
        f"{peak:.2f} GiB")

    for lever, want in (("xpk", {"_kernel_cross_packed": 5, "_kernel_mh_nat": 17}),
                        ("nat", {"_kernel_mh_nat": 22})):
        # twice: the second run shows the tensor-map cache in its steady state
        for which in ("first", "second"):
            out, counts, wall = map_cache(
                f"_CROSS_IMPL={lever}, the {which} 1-step generate", lambda: with_lever(
                    lever, lambda: counted_generate(sd, mod, "or", one, 8, args.seed)))
        expect_counts(f"_CROSS_IMPL={lever}, 1 step", counts, sd_or_step=1, flash_mha_eod=10,
                      geglu_ffn_block=16, **want)
        step_check(f"_CROSS_IMPL={lever}, 1 step ({wall * 1e3:.1f} ms with the text encoder)",
                   out, mod, one, lever)
        forward_check(f"_CROSS_IMPL={lever}", mod, one.height, lever)
        if lever == "xpk":
            launches["_kernel_cross_packed"] = counts["_kernel_cross_packed"]

    big = sd.SDPipelineConfig(num_inference_steps=1, height=768, width=768)
    out, counts, wall = counted_generate(sd, nat, "or", big, 8, args.seed)
    expect_counts("768 px flash_nat, 1 step", counts, sd_or_step=1, geglu_ffn_block=16,
                  _kernel=5, _kernel_mh_nat=27)
    step_check(f"768 px flash_nat, 1 step ({wall * 1e3:.1f} ms with the text encoder)", out,
               nat, big)
    forward_check("flash_nat, 768 px", nat, big.height)
    del out, nat, eo
    torch.cuda.empty_cache()
    for what, err, tol in asserts:
        if not err <= tol:
            raise AssertionError(f"{what}: {err} over its tolerance {tol}")
    return launches


def vae_encoder_reference_check(dev, seed):
    """One full-width ``VAEEncoder`` forward at 256 px on the card (bf16,
    random weights from ``seed``) against the same weights in fp32 on the
    host CPU."""
    import torch

    from superdiff_tpu_torch.models.from_jax import init_like_flax_
    from superdiff_tpu_torch.models.sd.vae import VAEConfig, VAEEncoder

    with torch.device(dev):
        enc = VAEEncoder(VAEConfig(), dtype=torch.bfloat16)
    init_like_flax_(enc, torch.Generator(device=dev).manual_seed(seed)).eval()
    cpu = VAEEncoder(VAEConfig(), dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in enc.state_dict().items()})
    cpu.eval()
    x = torch.randn(1, 256, 256, 3, generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        xd = x.to(dev)
        enc(xd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = enc(xd)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = got.cpu()
        ref = cpu(x)
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  VAEEncoder 256 px ({ms:.3f} ms on the card, bf16, vs fp32 on the CPU): "
        f"relative L2 error {rel:.3e} (tol 5e-2), output {tuple(got.shape)}")
    if got.shape != (1, 32, 32, 8) or not (torch.isfinite(got).all() and rel < 5e-2):
        raise AssertionError(f"VAEEncoder card-vs-CPU: shape {tuple(got.shape)}, error {rel}")


def sd_step_profile(sd, mod, args, dev, hw, **calls):
    """One captured ``hw`` px ``or`` step (the graph built before) under
    torch.profiler: device time and launches by kernel family (``calls``:
    the wrapper calls each step must replay), and the device's idle share
    in that run."""
    import torch

    cfg = sd.SDPipelineConfig(num_inference_steps=1, height=hw, width=hw)
    ctxs = sd.prepare_contexts(mod, "or", *PROMPTS, 8)
    sampler = sd.make_sampler(mod, "or", cfg, capture=True)
    gen = lambda: torch.Generator(device=dev).manual_seed(args.seed)
    float(sampler(*ctxs, generator=gen())[0].sum())  # its first call: step 0, the capture
    fams, wall, counts = profile_by_family(
        lambda: sampler(*ctxs, generator=gen()),
        OUT / f"chip_smoke_sd{hw}_profile.txt")
    total = sum(fams.values())
    log(f"  profile (one captured {hw} px or step): {total:.3f} ms device time, {wall:.3f} ms "
        f"wall under the profiler (device idle {1 - total / wall:.3f}); by family (ms): " +
        ", ".join(f"{k} {v:.4f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])))
    expect_profiled_launches(f"captured {hw} px or", counts, 1, **calls)


def inception_npz(path, seed):
    """Seed-drawn InceptionV3 weights in the JAX package's converted layout
    (``conv{i}/kernel`` HWIO, ``conv{i}/bias``, ``predictions/...``), the
    distributions of JAX ``inception.init_params``: normal kernels of
    variance 2 / fan_in (1 / fan_in for the head), zero biases."""
    import numpy as np

    from superdiff_tpu_torch.models import inception

    shapes = inception.InceptionV3(include_top=True)
    rng = np.random.default_rng(seed)
    params = {}
    for i, conv in enumerate(shapes.convs):
        o, c, kh, kw = conv.weight.shape
        k = rng.standard_normal((kh, kw, c, o), dtype=np.float32)
        params[f"conv{i}"] = {"kernel": k * np.float32(np.sqrt(2.0 / (kh * kw * c))),
                              "bias": np.zeros(o, np.float32)}
    k = rng.standard_normal((inception.POOL_DIM, inception.NUM_CLASSES), dtype=np.float32)
    params["predictions"] = {"kernel": k * np.float32(np.sqrt(1.0 / inception.POOL_DIM)),
                             "bias": np.zeros(inception.NUM_CLASSES, np.float32)}
    inception.save_npz(params, str(path))
    return params


def train_metrics(workdir):
    import json

    with open(Path(workdir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def train_run(cfg, workdir, dev, what):
    """``pipelines.cifar.train`` of ``cfg`` from scratch: its wall, the loop's
    ms per step from ``metrics.jsonl`` (``log_every`` steps between the
    synced loss reads, the first two intervals left out as warmups), the
    loss finite, and the parameters and EMA moved from the initial draw.
    Returns the state."""
    import statistics

    import torch

    from superdiff_tpu_torch.pipelines import cifar

    _, state0, _, _ = cifar.init_state(cfg, str(Path(workdir) / "initial"), device=dev)
    p0 = {n: p.detach().clone() for n, p in state0.params.items()}
    del state0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = cifar.train(cfg, str(workdir), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recs = train_metrics(workdir)
    losses = [r["loss"] for r in recs]
    loop_ms = statistics.median(1e3 / r["steps_per_sec"] for r in recs[2:])
    moved = sum((p.detach() - p0[n]).float().norm() ** 2 for n, p in state.params.items()) ** 0.5
    ema_moved = sum((state.params_ema[n] - p0[n]).float().norm() ** 2 for n in p0) ** 0.5
    size = sum(p.float().norm() ** 2 for p in p0.values()) ** 0.5
    ckpts = sorted(p.name for p in (Path(workdir) / "checkpoints").iterdir())
    log(f"  train {what} ({cfg.train_split}, {cfg.n_iters} steps, batch {cfg.batch_size}, "
        f"dropout {cfg.dropout}, {cfg.compute_dtype}): {wall:.3f} s wall, data and "
        f"checkpoints included; loop {loop_ms:.3f} ms per step ({cfg.batch_size / loop_ms * 1e3:.1f}"
        f" images/s; median over logged intervals 3-{len(recs)}, {cfg.log_every} steps each); "
        f"peak memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} held before; losses "
        f"{[round(v, 3) for v in losses]}; |params - initial| / |initial| "
        f"{(moved / size).item():.3e}, EMA {(ema_moved / size).item():.3e}; checkpoints {ckpts}")
    if state.step != cfg.n_iters + 1:
        raise AssertionError(f"{what}: state.step {state.step} != {cfg.n_iters + 1}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: loss not finite: {losses}")
    if not (0 < ema_moved < moved):
        raise AssertionError(f"{what}: params moved {moved}, EMA {ema_moved}")
    return state


def train_step_timing(state, cfg, dev, steps=10):
    """ms per train step on one batch, host clock around each synced step
    after two synced warmups, and the peak memory of those steps (all the
    card holds, the state included)."""
    import statistics

    import torch

    from superdiff_tpu_torch.core.dsm import make_dsm_loss
    from superdiff_tpu_torch.core.schedules import VPSchedule
    from superdiff_tpu_torch.data.datasets import ImageDataset
    from superdiff_tpu_torch.pipelines import cifar
    from superdiff_tpu_torch.train import make_optimizer, make_train_step

    opt = make_optimizer(cfg.lr, cfg.warmup, grad_clip=cfg.grad_clip)
    step = make_train_step(opt, make_dsm_loss(cifar._apply_fn(state.model), VPSchedule()))
    host = next(ImageDataset(cfg.dataset, cfg.train_split, seed=5).batches(cfg.batch_size))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    for _ in range(2):
        step(state, batch)
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    log(f"  train step (batch {cfg.batch_size}, synced, after two warmups): median {ms:.3f} ms "
        f"({cfg.batch_size / ms * 1e3:.1f} images/s) over {steps} "
        f"{[round(v, 3) for v in times]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return step, batch


def checkpoint_reload_check(state, cfg, workdir, dev):
    """The latest checkpoint, restored by ``init_state`` into a fresh state,
    equals the state ``train`` returned, bit for bit."""
    import torch

    from superdiff_tpu_torch.pipelines import cifar

    _, back, _, _ = cifar.init_state(cfg, str(workdir), device=dev)
    same = [back.step == state.step, back.run_id == state.run_id,
            torch.equal(back.sampler_state, state.sampler_state),
            torch.equal(back.generator.get_state(), state.generator.get_state()),
            back.schedule.state_dict() == state.schedule.state_dict()]
    for n, p in state.params.items():
        q = back.params[n]
        same += [torch.equal(p, q), torch.equal(state.params_ema[n], back.params_ema[n])]
        same += [torch.equal(v, back.optimizer.state[q][k])
                 for k, v in state.optimizer.state[p].items()]
    log(f"  checkpoint reload (init_state of the run dir): {sum(same)} of {len(same)} "
        f"tensors and fields bit-identical to the saved state")
    if not all(same):
        raise AssertionError("a checkpoint did not reload bit-identical")


def fresh_train_state(cfg, dev, seed):
    """A TrainState of ``cfg`` on ``dev`` with drawn non-zero parameters
    (the Flax init's zero output layers would keep the gradients out of the
    net) and its DSM step."""
    import torch

    from superdiff_tpu_torch.core.dsm import make_dsm_loss
    from superdiff_tpu_torch.core.schedules import VPSchedule
    from superdiff_tpu_torch.pipelines import cifar
    from superdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    with torch.device(dev):
        model = cfg.model()
    draw_nonzero_(model, seed)
    opt = make_optimizer(cfg.lr, cfg.warmup, grad_clip=cfg.grad_clip)
    state = init_train_state(torch.Generator(device=dev).manual_seed(seed), model, opt,
                             ema_rate=cfg.ema_rate)
    loss_fn = make_dsm_loss(cifar._apply_fn(model), VPSchedule())
    return state, make_train_step(opt, loss_fn), loss_fn


def train_step_reference_check(cfg, dev, batch_size=16):
    """One train step at dropout 0 on the card (bf16) and in fp32 on the host
    CPU, from the same drawn state, batch and eps: the loss within 5e-2
    relative, the gradients within 5e-2 relative L2 (the bound of the
    forward checks of phase 5), the next cursor bit for bit, and the
    parameters unchanged on both sides (the warmup's first rate is 0)."""
    import dataclasses

    import torch

    from superdiff_tpu_torch.data.datasets import ImageDataset

    cfg = dataclasses.replace(cfg, dropout=0.0)
    card, card_step, card_loss = fresh_train_state(cfg, dev, 21)
    cpu, cpu_step, cpu_loss = fresh_train_state(
        dataclasses.replace(cfg, compute_dtype="float32"), torch.device("cpu"), 21)
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    host = next(ImageDataset(cfg.dataset, cfg.train_split, seed=9).batches(batch_size))
    eps = torch.randn(host["image"].shape, generator=torch.Generator().manual_seed(22))
    grads, losses = {}, {}
    for name, state, loss_fn, step, d in (("card", card, card_loss, card_step, dev),
                                          ("cpu", cpu, cpu_loss, cpu_step, "cpu")):
        batch = {k: torch.from_numpy(v).to(d) for k, v in host.items()}
        loss, _ = loss_fn(state.sampler_state, batch, eps=eps.to(d))
        grads[name] = torch.cat([g.flatten().cpu() for g in torch.autograd.grad(
            loss, list(state.model.parameters()))])
        before = {n: p.detach().clone() for n, p in state.params.items()}
        t0 = time.perf_counter()
        _, losses[name] = step(state, batch, eps=eps.to(d))
        losses[name] = losses[name].item()
        if name == "cpu":
            cpu_s = time.perf_counter() - t0
        if not all(torch.equal(p, before[n]) for n, p in state.params.items()):
            raise AssertionError(f"{name}: the first update moved the parameters")
    rel_loss = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    rel_grad = rel_l2(grads["card"], grads["cpu"])
    same_cursor = card.sampler_state.cpu().numpy().tobytes() == cpu.sampler_state.numpy().tobytes()
    log(f"  train step, bf16 on the card vs fp32 on the CPU ({cpu_s:.1f} s), batch "
        f"{batch_size}, dropout 0, drawn weights: loss {losses['card']:.6g} vs "
        f"{losses['cpu']:.6g} (relative {rel_loss:.3e}, tol 5e-2), gradients relative L2 "
        f"{rel_grad:.3e} (tol 5e-2, |g| {grads['cpu'].norm().item():.4g}), cursor "
        f"{'bit-identical' if same_cursor else 'DIFFERS'}, parameters unchanged by the "
        f"first update on both")
    if not (rel_loss < 5e-2 and rel_grad < 5e-2 and same_cursor):
        raise AssertionError("the card's train step differs from the CPU's")


def resume_check(cfg, workdir, dev, steps=4):
    """``steps`` train steps straight, against ``steps // 2``, a checkpoint,
    a fresh state restored from it and the rest, on the same batches
    (dropout on, eps from the state's generator): the step, cursor and
    generator state exactly, and the parameters, EMA and Adam moments bit
    for bit or, where cuDNN's backward convolutions are not deterministic,
    within 2 x the summed learning rates (parameters, EMA) and 1e-3 of the
    largest moment."""
    import torch

    from superdiff_tpu_torch.data.datasets import ImageDataset
    from superdiff_tpu_torch.train import checkpoints

    it = ImageDataset(cfg.dataset, cfg.train_split, seed=11).batches(cfg.batch_size)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
               for _ in range(steps)]

    def run(resume_at=None):
        state, step, _ = fresh_train_state(cfg, dev, 31)
        for i, b in enumerate(batches):
            if i == resume_at:
                mgr = checkpoints.make_manager(str(workdir))
                checkpoints.save(mgr, i, state)
                state, step, _ = fresh_train_state(cfg, dev, 31)
                checkpoints.restore_latest(mgr, state)
            step(state, b)
        torch.cuda.synchronize()
        return state

    straight, resumed = run(), run(resume_at=steps // 2)
    lrs = sum(cfg.lr * min(k / cfg.warmup, 1.0) for k in range(steps))
    worst = {"params": 0.0, "params_ema": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0}
    exact = True
    for n, p in straight.params.items():
        q = resumed.params[n]
        pairs = {"params": (p, q), "params_ema": (straight.params_ema[n], resumed.params_ema[n])}
        for k in ("exp_avg", "exp_avg_sq"):
            pairs[k] = (straight.optimizer.state[p][k], resumed.optimizer.state[q][k])
        for k, (a, b) in pairs.items():
            exact &= torch.equal(a, b)
            scale = 1.0 if k.startswith("params") else straight.optimizer.state[p][k].abs().max()
            worst[k] = max(worst[k], ((a - b).abs().max() / max(float(scale), 1e-30)).item())
    same = (straight.step == resumed.step == steps + 1
            and torch.equal(straight.sampler_state, resumed.sampler_state)
            and torch.equal(straight.generator.get_state(), resumed.generator.get_state()))
    log(f"  resume ({steps} steps straight vs {steps // 2} + checkpoint + restore + "
        f"{steps - steps // 2}, batch {cfg.batch_size}, dropout {cfg.dropout}): "
        f"{'bit-identical' if exact else 'not bit-identical'}; max |diff| params "
        f"{worst['params']:.3e}, EMA {worst['params_ema']:.3e} (tol {2 * lrs:.3e} = 2 x the "
        f"summed learning rates), Adam moments {worst['exp_avg']:.3e} / "
        f"{worst['exp_avg_sq']:.3e} of the largest (tol 1e-3); step, cursor and generator "
        f"{'equal' if same else 'DIFFER'}")
    if not (same and worst["params"] <= 2 * lrs and worst["params_ema"] <= 2 * lrs
            and worst["exp_avg"] <= 1e-3 and worst["exp_avg_sq"] <= 1e-3):
        raise AssertionError("the resumed run differs from the straight run")


def inception_reference_check(weights, dev, n=4, n_timed=1000):
    """Pool3 features of ``n`` images on the card (fp32 convolutions, the
    flags this script runs under) against the same weights in fp32 on the
    host CPU: within 1e-3 of the largest. Then the throughput of ``n_timed``
    images with cuDNN's TF32 off (as here) and on (PyTorch's default), in
    turns, and the TF32 features' distance from the CPU's (printed, not
    held: no path of this script runs TF32)."""
    import statistics

    import numpy as np
    import torch

    from superdiff_tpu_torch.models import inception

    imgs = np.random.default_rng(13).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    fn = inception.make_feature_fn(weights, device=dev)
    got = fn(imgs)
    t0 = time.perf_counter()
    ref = inception.make_feature_fn(weights, device="cpu")(imgs)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    log(f"  InceptionV3 pool3, {n} images, card vs fp32 CPU ({time.perf_counter() - t0:.1f} s):"
        f" max |diff| {err:.3e} of the largest feature (tol 1e-3)")
    if not (np.isfinite(got).all() and err < 1e-3):
        raise AssertionError(f"Inception card-vs-CPU error {err}")
    many = np.random.default_rng(14).integers(0, 256, (n_timed, 32, 32, 3), dtype=np.uint8)
    rates, tf32_err = {False: [], True: []}, None
    try:
        for tf32 in (False, True, True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            fn(many[:128])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(many)
            rates[tf32].append(n_timed / (time.perf_counter() - t0))
            if tf32:
                tf32_err = np.abs(fn(imgs) - ref).max() / np.abs(ref).max()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    log(f"  InceptionV3 features, {n_timed} images in batches of 128, in turns: fp32 "
        f"{statistics.median(rates[False]):.1f} images/s, TF32 {statistics.median(rates[True]):.1f}"
        f" images/s ({[round(v, 1) for v in rates[False]]}, {[round(v, 1) for v in rates[True]]});"
        f" TF32 features vs fp32 CPU: max |diff| {tf32_err:.3e} of the largest")


def train_eval_phase(dev, args):
    """Phase 6: the CIFAR training and FID-evaluation path at full width
    (the ``vpsde_less_5`` / ``vpsde_more_5`` configs as published: nf 128,
    ch_mult (1,2,2,2), attention at 16 and 8, dropout 0.1, batch 128, bf16,
    lr 2e-4, warmup 5000, EMA 0.9999) on the synthetic CIFAR-10 stand-in,
    cut to ``--train-steps`` steps each; the files go to
    ``build/chip_smoke_train`` (removed at the end)."""
    import dataclasses
    import shutil

    import torch

    from superdiff_tpu_torch.pipelines import cifar

    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    log(f"  card: {card_line()}")
    log(f"  torch.backends: cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}, cudnn.deterministic "
        f"{torch.backends.cudnn.deterministic}")
    n = args.train_steps
    cut = dict(n_iters=n, save_every=n // 2, log_every=5, num_samples=200)
    cfg_a = cifar.CONFIGS["vpsde_less_5"](**cut)
    cfg_b = cifar.CONFIGS["vpsde_more_5"](seed=2, **cut)
    state_a = train_run(cfg_a, work / "a", dev, "A")
    checkpoint_reload_check(state_a, cfg_a, work / "a", dev)
    step, batch = train_step_timing(state_a, cfg_a, dev)
    state_b = train_run(cfg_b, work / "b", dev, "B")
    del state_b
    torch.cuda.empty_cache()
    resumed = cifar.train(cfg_a, str(work / "a"), n_iters=n + 2, device=dev)
    log(f"  train A again with n_iters {n + 2}: resumed from checkpoint {n}, ends at step "
        f"{resumed.step} (want {n + 3})")
    if resumed.step != n + 3:
        raise AssertionError(f"resume ended at step {resumed.step}")
    del resumed
    resume_check(cfg_a, work / "resume", dev)
    train_step_reference_check(cfg_a, dev)
    torch.cuda.empty_cache()

    weights_path = work / "inception.npz"
    t0 = time.perf_counter()
    weights = inception_npz(weights_path, args.seed)
    log(f"  seed-drawn InceptionV3 weights written as a JAX-layout .npz: "
        f"{time.perf_counter() - t0:.1f} s")
    # the statistics of a 6 000-image CIFAR-10 stand-in written as files
    # (the synthetic stand-in's 60 000 cut for the script's time)
    write_cifar10(work / "fid_data", 1000, args.seed)
    os.environ["SUPERDIFF_DATA_DIR"] = str(work / "fid_data")
    t0 = time.perf_counter()
    try:
        stats_dir = cifar.fid_stats(cfg_a, str(work), inception_weights=str(weights_path),
                                    device=dev)
        torch.cuda.synchronize()
    finally:
        del os.environ["SUPERDIFF_DATA_DIR"]
    wall = time.perf_counter() - t0
    import numpy as np

    stats = {s: np.load(Path(stats_dir) / f"cifar10_{s}_stats.npz")["pool_3"]
             for s in ("train", "test")}
    n_imgs = sum(len(v) for v in stats.values())
    log(f"  fid_stats (a CIFAR-10 stand-in, train + test, seed-drawn Inception weights): "
        f"{n_imgs} images in {wall:.3f} s ({n_imgs / wall:.1f} images/s, data included); "
        f"pool_3 {', '.join(f'{k} {v.shape}' for k, v in stats.items())}")
    inception_reference_check(weights, dev)

    stats_path = str(Path(stats_dir) / "cifar10_train_stats.npz")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = cifar.evaluate_joint_fid(cfg_a, str(work / "joint"), [str(work / "a"),
                                      str(work / "b")], stoch=True, operator="or",
                                      stats_path=stats_path,
                                      inception_weights=str(weights_path), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    files = sorted(p.name for p in (work / "joint" / "eval" / "samples_stoch").iterdir())
    batches = math.ceil(cfg_a.num_samples / cfg_a.eval_batch_size)
    log(f"  evaluate_joint_fid (OR, SDE, {cfg_a.n_sample_steps} steps, batch "
        f"{cfg_a.eval_batch_size}, {cfg_a.num_samples} samples, captured sampler): "
        f"{wall:.3f} s wall (checkpoints, sampling, Inception, FID); FID {report.get('fid')} "
        f"(random Inception weights: plumbing, not quality); {len(files)} sample files "
        f"(want {batches})")
    expect_counts("evaluate_joint_fid (wrapper calls: step 0 and the capture)", counts,
                  fused_sde_step=2)
    if not (set(files) == {f"samples_{i}.npz" for i in range(batches)}
            and math.isfinite(report.get("fid", math.nan))):
        raise AssertionError(f"evaluate_joint_fid: report {report}, files {files}")
    torch.cuda.empty_cache()

    # profiled last: a torch.profiler run slows the later launches
    fams, wall, _ = profile_by_family(lambda: [step(state_a, batch) for _ in range(3)],
                                      OUT / "chip_smoke_train_profile.txt")
    total = sum(fams.values())
    log(f"  profile (3 train steps, batch {cfg_a.batch_size}): {total / 3:.3f} ms device time "
        f"per step, {wall / 3:.3f} ms wall per step under the profiler (device idle "
        f"{1 - total / wall:.3f}); by family (ms per step): " + ", ".join(
            f"{k} {v / 3:.4f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])))
    del state_a
    torch.cuda.empty_cache()
    short = dataclasses.replace(cfg_a, n_sample_steps=10, num_samples=200)
    # no stats: the FID's square root on the host would take most of each run
    counted_runs("evaluate_joint_fid, OR, SDE, 10 steps, 2 batches",
                 lambda: cifar.evaluate_joint_fid(
                     short, str(work / "counted"), [str(work / "a"), str(work / "b")],
                     inception_weights=str(weights_path), device=dev),
                 short.n_sample_steps * 2, fused_sde_step=1)
    shutil.rmtree(work)


# card vs CPU over 10 composed steps: the largest translation difference over
# the largest translation, and the largest quaternion difference. fp32 rounding
# (cuBLAS against the CPU's sums) carried through 10 steps of two drawn nets:
# 2.2e-4 / 2.5e-4 for the reference pair, 1.4e-6 / 3.6e-7 for the IPA pair
# (measured on an H100 80GB HBM3 at 700 W), so 1e-3 leaves room for another
# card's rounding.
PROTEIN_TOL = 1e-3


def scale_update_heads_(net, s=0.1):
    """Scale the backbone-update heads of a drawn net, so that each block
    moves the frames by a few angstroms rather than tens."""
    import torch

    with torch.no_grad():
        for name, p in net.named_parameters():
            if "bb_update" in name:
                p.mul_(s)
    return net


def protein_nets(se3, dev, seed):
    """The reference pair at the checkpoints' ``model_conf`` widths (the
    schemas in ``tests/fixtures``), Proteus (model a) and FrameDiff (model
    b), and the CLI's random-init pair, ``IPAConfig.proteus_like()`` and
    ``framediff_like()``: every parameter drawn non-zero from ``seed``
    (``draw_nonzero_``; a zero update head leaves each frame as it came in,
    and the rotation score at an identity relative rotation is rounding),
    the update heads scaled by 0.1. Eight input columns of Proteus's
    template angle embedder get zero weights: the sin / cos of residue 0's
    pre-omega and phi, whose frames are built with the absent previous
    residue's atoms (zeros) and are degenerate, so their sign follows
    rounding (the card and the CPU round them apart)."""
    import torch

    from superdiff_tpu_torch.models.protein import IPAConfig, IPAScoreNetwork
    from superdiff_tpu_torch.models.protein.framediff import FrameDiffConfig, \
        FrameDiffScoreNetwork
    from superdiff_tpu_torch.models.protein.proteus import ProteusConfig, ProteusScoreNetwork

    confs = {n: json.loads((ROOT / "tests" / "fixtures" / f"{n}_state_dict_schema.json")
                           .read_text())["model_conf"] for n in ("proteus", "framediff")}
    with torch.device(dev):
        nets = {"Proteus": ProteusScoreNetwork(ProteusConfig.from_ckpt_conf(confs["proteus"])),
                "FrameDiff": FrameDiffScoreNetwork(
                    FrameDiffConfig.from_ckpt_conf(confs["framediff"]), score_calc=se3),
                "IPA proteus_like": IPAScoreNetwork(IPAConfig.proteus_like(), se3),
                "IPA framediff_like": IPAScoreNetwork(IPAConfig.framediff_like(), se3)}
    for i, net in enumerate(nets.values()):
        scale_update_heads_(draw_nonzero_(net, seed + i)).eval()
    emb = nets["Proteus"].embedding_layer.template_embedder.template_angle_embedder
    with torch.no_grad():
        emb.linear_1.weight[:, [22, 23, 24, 25, 36, 37, 38, 39]] = 0.0
    return nets


def model_fns(a, b, se3):
    """(model_a, model_b, sc_adapter_a) for ``compose``."""
    from superdiff_tpu_torch import cli

    if type(a).__name__ == "ProteusScoreNetwork":
        model_a, adapter = cli.proteus_model_fn(a, se3)
    else:
        model_a, adapter = cli.net_model_fn(a), None
    return model_a, cli.net_model_fn(b), adapter


def on_cpu(net, cpu_se3):
    """A CPU copy of ``net`` (the same parameters) scoring with ``cpu_se3``."""
    import copy

    cpu = copy.deepcopy(net).to("cpu")
    for attr in ("se3_diffuser", "score_calc"):
        if getattr(cpu, attr, None) is not None:
            setattr(cpu, attr, cpu_se3)
    return cpu


def check_composition(what, out, n, operator):
    """Every output of one ``compose`` run finite, unit quaternions, kappa in
    [0, 1] where the operator bounds it (OR, mixture; AND's closed form does
    not), atom37 (1, n, 37, 3), and a PDB of n residues."""
    import torch

    from superdiff_tpu_torch.models.protein import backbone

    tr = out["traces"]
    bad = [k for k, v in [("rigids", out["rigids"]), ("atom37", out["atom37"]), *tr.items()]
           if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{what}: not finite: {bad}")
    qerr = (out["rigids"][..., :4].norm(dim=-1) - 1).abs().max().item()
    if qerr > 1e-5:
        raise AssertionError(f"{what}: quaternion norms off by {qerr:.3e}")
    k = torch.stack([tr["kappa_trans"], tr["kappa_rots"]])
    if operator != "AND" and not ((k >= 0) & (k <= 1)).all():
        raise AssertionError(f"{what}: kappa out of [0, 1]: {k.min().item()} {k.max().item()}")
    if out["atom37"].shape != (1, n, 37, 3):
        raise AssertionError(f"{what}: atom37 {tuple(out['atom37'].shape)}")
    pdb = backbone.to_pdb(out["atom37"][0])
    if pdb.count(" CA ") != n:
        raise AssertionError(f"{what}: the PDB holds {pdb.count(' CA ')} residues, want {n}")
    log(f"  {what}: finite; max ||q| - 1| {qerr:.1e}; kappa_trans last "
        f"{tr['kappa_trans'][-1, 0].item():.6f}, kappa over the run in [{k.min().item():.6f}, "
        f"{k.max().item():.6f}]; ll_a / ll_b trans last {tr['ll_a_trans'][-1, 0].item():.3f} / "
        f"{tr['ll_b_trans'][-1, 0].item():.3f}; atom37 {tuple(out['atom37'].shape)}; PDB of "
        f"{n} residues")


def timed_compose(what, run, steps):
    """``run()`` once, synced (after the caller's warm-up): prints wall, ms
    per step and the peak memory above what was held; returns the output."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"  {what}: {wall:.3f} s wall, {wall / steps * 1e3:.3f} ms per step over {steps} "
        f"steps, peak {peak:.3f} GiB above the {base / 2**30:.3f} GiB held")
    return out


def card_against_cpu(nets, se3, cpu_se3, dev, seed):
    """The four nets' forwards and a 10-step ``compose`` OR of each pair at
    length 64, on the card and on the CPU with the same weights, inputs,
    ``init_rigids`` and noise."""
    import torch

    from superdiff_tpu_torch import cli
    from superdiff_tpu_torch.pipelines import protein

    n = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    r7 = se3.sample_ref(n, 1, generator=g)
    feats = {"rigids_t": r7, "res_mask": torch.ones((1, n), device=dev),
             "fixed_mask": torch.zeros((1, n), device=dev),
             "t": torch.full((1,), 0.6, device=dev), "seq_idx": torch.arange(n, device=dev)[None],
             "sc_ca_t": r7[..., 4:] + torch.randn((1, n, 3), generator=g, device=dev)}
    cpu_nets = {k: on_cpu(v, cpu_se3) for k, v in nets.items()}
    keys = {"Proteus": ("rigids", "final_atom_positions", "node_embed", "edge_embed"),
            "FrameDiff": ("rigids", "psi", "rot_score", "trans_score")}
    for name, net in nets.items():
        f = cli.proteus_feats(feats) if name == "Proteus" else feats
        with torch.no_grad():
            got, ref = net(f), cpu_nets[name]({k: v.cpu() for k, v in f.items()})
        errs = {k: ((got[k].cpu() - ref[k]).abs().max() / ref[k].abs().max()).item()
                for k in keys.get(name, ("rigids", "psi", "rot_score", "trans_score"))}
        log(f"  {name} forward, length {n}, card vs CPU (fp32, TF32 off): error over the "
            f"CPU's largest output: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
            " (tol 1e-3)")
        if not max(errs.values()) <= 1e-3:
            raise AssertionError(f"{name}: card vs CPU {errs}")
    steps = 10
    init = se3.sample_ref(n, 1, generator=g)
    noise = torch.randn((steps, 1, n, 3), generator=g, device=dev)
    cfg = protein.CompositionConfig(num_t=steps + 1)
    for what, (a, b) in (("Proteus + FrameDiff", ("Proteus", "FrameDiff")),
                         ("IPA pair", ("IPA proteus_like", "IPA framediff_like"))):
        outs, secs = [], []
        for ns, s3, target in ((nets, se3, dev), (cpu_nets, cpu_se3, "cpu")):
            ma, mb, ad = model_fns(ns[a], ns[b], s3)
            t0 = time.perf_counter()
            outs.append(protein.compose(ma, mb, s3, n_res=n, cfg=cfg, sc_adapter_a=ad,
                                        init_rigids=init.to(target), noise=noise.to(target)))
            secs.append(time.perf_counter() - t0)
        got, ref = outs[0], outs[1]
        d_tr = (got["rigids"][..., 4:].cpu() - ref["rigids"][..., 4:]).abs().max().item()
        d_q = (got["rigids"][..., :4].cpu() - ref["rigids"][..., :4]).abs().max().item()
        d_k = (got["traces"]["kappa_trans"].cpu()
               - ref["traces"]["kappa_trans"]).abs().max().item()
        big = ref["rigids"][..., 4:].abs().max().item()
        log(f"  compose OR, {what}, length {n}, {steps} steps, card vs CPU on the same "
            f"init_rigids and noise: translations {d_tr:.3e} A (largest {big:.3f} A), "
            f"quaternions {d_q:.3e}, kappa_trans {d_k:.3e} (tol {PROTEIN_TOL:g}); card "
            f"{secs[0]:.1f} s, CPU {secs[1]:.1f} s (beside the CLI run)")
        if not (d_tr <= PROTEIN_TOL * big and d_q <= PROTEIN_TOL):
            raise AssertionError(f"{what}: card vs CPU over {steps} steps beyond tolerance")


def protein_phase(dev, args):
    """Phase 7: SE(3) protein composition (``pipelines.protein.compose``)."""
    import tempfile

    import numpy as np
    import torch

    from superdiff_tpu_torch.models.protein import SE3Diffuser
    from superdiff_tpu_torch.pipelines import protein

    log(f"  card: {card_line()}")
    t0 = time.perf_counter()
    se3 = SE3Diffuser.default(device=dev)
    torch.cuda.synchronize()
    log(f"  SE3Diffuser.default(): IGSO(3) tables {tuple(se3.so3.score_norm.shape)}, 1000 "
        f"series terms, built on the host and moved to the card: "
        f"{time.perf_counter() - t0:.2f} s")
    cpu_se3 = se3.to("cpu")
    ts = torch.tensor(np.linspace(0.002, 1.0, 500)[::-1][:-1].copy(), dtype=torch.float32)
    if not torch.equal(se3.so3.t_to_idx(ts.to(dev)).cpu(), cpu_se3.so3.t_to_idx(ts)):
        raise AssertionError("the card's IGSO(3) rows for the 500-step schedule differ from "
                             "the CPU's")
    log("  the 499 stepped t of the 500-step schedule pick the same IGSO(3) table rows on the "
        "card as on the CPU")

    t0 = time.perf_counter()
    nets = protein_nets(se3, dev, args.seed)
    log("  nets (drawn weights): " + ", ".join(
        f"{k} {sum(p.numel() for p in v.parameters()) / 1e6:.3f} M parameters "
        f"({len(v.state_dict())} tensors)" for k, v in nets.items()) +
        f"; {time.perf_counter() - t0:.2f} s")
    model_a, model_b, adapter = model_fns(nets["Proteus"], nets["FrameDiff"], se3)

    def run(n, steps, **kw):
        cfg = protein.CompositionConfig(num_t=steps + 1, **kw)
        return protein.compose(model_a, model_b, se3, n_res=n, cfg=cfg, sc_adapter_a=adapter,
                               seed=args.seed)

    log_phase("  composed runs")
    run(100, 2)  # warm-up
    runs = [("OR, length 100, batch 1, 100 steps (num_t 101, cut from 500)", 100, 100, {},
             "OR"),
            ("AND, length 100, 20 steps (num_t 21, cut from 500)", 100, 20,
             dict(kappa_operator="AND"), "AND"),
            ("mixture, length 100, 20 steps (num_t 21, cut from 500)", 100, 20,
             dict(mixing_method="mixture"), "OR"),
            ("OR, length 300, 20 steps (num_t 21, cut from 500)", 300, 20, {}, "OR")]
    for what, n, steps, kw, op in runs:
        if n == 300:
            run(300, 1)  # warm-up at the new shapes
        zero_counts()
        out = timed_compose(f"Proteus + FrameDiff {what}", lambda: run(n, steps, **kw), steps)
        expect_counts(f"protein {what}", read_counts())
        check_composition(what, out, n, op)
        del out
    torch.cuda.empty_cache()

    # the CLI on the card, in a process of its own beside the card-vs-CPU
    # checks (they time nothing), and waited for before the profile
    log_phase("  the CLI, beside the card against the CPU (length 64)")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "superdiff_tpu_torch.cli", "protein",
                                 "--length", "100", "--num_t", "20", "--out_dir", tmp],
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        try:
            card_against_cpu(nets, se3, cpu_se3, dev, args.seed)
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
            proc.wait()
        wall = time.perf_counter() - t0
        lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
        pdbs = sorted(Path(tmp).glob("*.pdb"))
    log(f"  python -m superdiff_tpu_torch.cli protein --length 100 --num_t 20 (the IPA pair, "
        f"Flax-distribution random init): exit {proc.returncode} in {wall:.1f} s; "
        f"{len(pdbs)} PDB, {len(lines)} JSON line(s): {lines}")
    if proc.returncode != 0 or len(pdbs) != 1 or len(lines) != 1:
        raise AssertionError(f"the protein CLI failed: {stderr[-2000:]}")
    torch.cuda.empty_cache()

    # profiled after every timing: a torch.profiler run slows later launches
    log_phase("  profile")
    fams, wall, _ = profile_by_family(lambda: run(100, 5),
                                      OUT / "chip_smoke_protein_profile.txt", cycles=1,
                                      cpu=False)
    total = sum(fams.values())
    log(f"  profile (Proteus + FrameDiff OR, length 100, 5 steps): {total / 5:.3f} ms device "
        f"time per step, {wall / 5:.3f} ms wall per step under the profiler (device idle "
        f"{1 - total / wall:.3f}); by family (ms per step): " + ", ".join(
            f"{k} {v / 5:.4f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])))
    log_phase("  phase 7 done")


# card vs CPU of the full-width MPNN + ESM2 conditioner on the same draws:
# every output over the CPU's largest (fp32, TF32 off)
STRUCT2SEQ_TOL = 1e-3


def helix_ca(n, rng):
    """A CA trace of an alpha helix (2.3 A radius, 1.5 A rise, 100 degrees a
    residue) with 0.2 A of noise drawn from ``rng``."""
    import numpy as np

    t = np.arange(n) * np.deg2rad(100.0)
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], -1)
    return (ca + 0.2 * rng.standard_normal(ca.shape)).astype(np.float32)


def struct2seq_nets(se3, dev, seed):
    """Proteus at the reference checkpoint's ``model_conf`` with its
    ``struct2seq`` section enabled (c_s 256, c_z 128, seq_nums 4) and
    FrameDiff at its checkpoint's, drawn as ``protein_nets`` draws them; the
    MPNN + ESM conditioner at ``MPNNESMConfig()`` (ProteinMPNN 128 wide, 3 + 3
    layers, k 48; ESM2 esm2_t33_650M: 33 x 1280, 20 heads) with the Flax
    initialisers' distributions from ``seed``, attached as Proteus's
    ``struct2seq_embedder``."""
    import copy

    import torch

    from superdiff_tpu_torch.models.protein import struct2seq
    from superdiff_tpu_torch.models.protein.framediff import FrameDiffConfig, \
        FrameDiffScoreNetwork
    from superdiff_tpu_torch.models.protein.proteus import ProteusConfig, ProteusScoreNetwork

    confs = {n: json.loads((ROOT / "tests" / "fixtures" / f"{n}_state_dict_schema.json")
                           .read_text())["model_conf"] for n in ("proteus", "framediff")}
    pconf = copy.deepcopy(confs["proteus"])
    s2s_conf = pconf["embed"]["self_condition"]["struct2seq"]
    s2s_conf["enable"] = True
    pcfg = ProteusConfig.from_ckpt_conf(pconf)
    with torch.device(dev):
        proteus = ProteusScoreNetwork(pcfg)
        framediff = FrameDiffScoreNetwork(FrameDiffConfig.from_ckpt_conf(confs["framediff"]),
                                          score_calc=se3)
    for i, net in enumerate((proteus, framediff)):
        scale_update_heads_(draw_nonzero_(net, seed + i)).eval()
    emb = proteus.embedding_layer.template_embedder.template_angle_embedder
    with torch.no_grad():
        emb.linear_1.weight[:, [22, 23, 24, 25, 36, 37, 38, 39]] = 0.0
    cfg = struct2seq.MPNNESMConfig(c_s=int(s2s_conf["c_s"]), c_z=int(s2s_conf["c_z"]),
                                   temperature=float(s2s_conf["temperature"]),
                                   seq_nums=int(s2s_conf["seq_nums"]))
    s2s = struct2seq.init_mpnn_esm(cfg, seed=seed + 2, device=dev)
    proteus.embedding_layer.struct2seq_embedder = s2s
    return proteus, framediff, s2s


def struct2seq_card_against_cpu(s2s, dev, seed, n=100):
    """The conditioner at full width on the card and on the CPU (the same
    weights and injected draws): the teacher-forced MPNN log-probs, ESM2's
    representations and attention maps of one tokenised sequence, and the
    whole ``MPNNESM`` (``esm_s``, ``esm_p``) on a helix self-condition."""
    import copy

    import numpy as np
    import torch

    from superdiff_tpu_torch.models.protein import residue_constants as rc
    from superdiff_tpu_torch.models.protein import struct2seq

    t0 = time.perf_counter()
    cpu = copy.deepcopy(s2s).to("cpu")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    pos = torch.zeros((1, n, 37, 3), device=dev)
    pos[0, :, rc.CA_IDX] = torch.as_tensor(helix_ca(n, rng), device=dev)
    sc = {"final_atom_positions": pos,
          "aatype": torch.full((1, n), rc.GLY_IDX, dtype=torch.long, device=dev)}
    draws = [struct2seq.mpnn_draws(1, n, g, dev) for _ in range(s2s.cfg.seq_nums)]
    s = torch.randint(0, 20, (1, n), generator=g, device=dev)
    order = torch.argsort(torch.rand((1, n), generator=g, device=dev), dim=-1)
    ones = torch.ones((1, n), device=dev)
    ridx = torch.arange(n, device=dev)[None]
    chain = torch.zeros((1, n), dtype=torch.long, device=dev)
    tokens = torch.randint(4, 24, (1, n + 2), generator=g, device=dev)
    tokens[:, 0], tokens[:, -1] = struct2seq.ESM_CLS, struct2seq.ESM_EOS

    def outputs(model, to):
        mv = lambda x: x.to(to)
        with torch.no_grad():
            lp = model.mpnn_model(mv(pos[:, :, rc.CA_IDX]), mv(s), mv(ones), mv(ones), mv(ridx),
                                  mv(chain), mv(order))
            esm = model.esm(mv(tokens))
            es, ep = model({k: mv(v) for k, v in sc.items()},
                           [{k: mv(v) for k, v in d.items()} for d in draws])
        return {"MPNN log-probs": lp, "ESM2 representations": esm["representations"],
                "ESM2 attentions": esm["attentions"], "esm_s": es, "esm_p": ep}

    got, ref = outputs(s2s, dev), outputs(cpu, "cpu")
    errs = {k: ((got[k].cpu() - ref[k]).abs().max() / ref[k].abs().max()).item() for k in ref}
    log(f"  MPNNESM, length {n}, {s2s.cfg.seq_nums} sequences, card vs CPU on the same "
        f"weights and injected draws (fp32, TF32 off): error over the CPU's largest output: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {STRUCT2SEQ_TOL:g}); {time.perf_counter() - t0:.1f} s")
    if not max(errs.values()) <= STRUCT2SEQ_TOL:
        raise AssertionError(f"MPNNESM card vs CPU: {errs}")
    del cpu


def struct2seq_composition(se3, dev, args):
    """Proteus (struct2seq on) + FrameDiff, OR over 20 steps at length 100,
    batch 1, ``esm_rate`` 0.2: the steps the gate names (0, 6, 13) run the
    branch, the others do not. Prints the ms of a struct2seq step and of a
    plain step and the peak memory."""
    import numpy as np
    import torch

    from superdiff_tpu_torch import cli
    from superdiff_tpu_torch.pipelines import protein

    t0 = time.perf_counter()
    proteus, framediff, s2s = struct2seq_nets(se3, dev, args.seed)
    torch.cuda.synchronize()
    log(f"  nets (drawn weights): Proteus {sum(p.numel() for p in proteus.parameters()) / 1e6:.3f}"
        f" M parameters of which MPNN {sum(p.numel() for p in s2s.mpnn_model.parameters()) / 1e6:.3f}"
        f" M and ESM2 {sum(p.numel() for p in s2s.esm.parameters()) / 1e6:.3f} M "
        f"({len(proteus.state_dict())} tensors in its state_dict), FrameDiff "
        f"{sum(p.numel() for p in framediff.parameters()) / 1e6:.3f} M; "
        f"{time.perf_counter() - t0:.2f} s")
    struct2seq_card_against_cpu(s2s, dev, args.seed)

    model_a, adapter = cli.proteus_model_fn(proteus, se3)
    model_b = cli.net_model_fn(framediff)
    n, steps, rate = 100, 20, 0.2
    state = {"step": -1, "stamps": [], "flags": [], "branch": []}
    hook = s2s.register_forward_hook(lambda m, i, o: state["branch"].append(state["step"]))

    def timed_a(feats, t):
        torch.cuda.synchronize()
        state["stamps"].append(time.perf_counter())
        state["step"] += 1
        state["flags"].append(bool(feats["struct2seq"]))
        return model_a(feats, t)

    def run(num_t, esm_rate):
        state.update(step=-1, stamps=[], flags=[], branch=[])
        cfg = protein.CompositionConfig(num_t=num_t, esm_rate=esm_rate)
        out = protein.compose(timed_a, model_b, se3, n_res=n, cfg=cfg, sc_adapter_a=adapter,
                              seed=args.seed)
        torch.cuda.synchronize()
        state["stamps"].append(time.perf_counter())
        return out

    run(3, 0.5)  # warm-up: step 0 with the branch, step 1 without
    num_esm = int(rate * (steps + 1))
    gate = sorted(set(np.linspace(0, steps, num_esm, dtype=int).tolist()) - {steps})
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = run(steps + 1, rate)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    expect_counts("struct2seq composition", read_counts())
    hook.remove()
    flagged = [i for i, f in enumerate(state["flags"]) if f]
    if flagged != gate or state["branch"] != gate:
        raise AssertionError(f"struct2seq gate {gate}: flagged {flagged}, the branch ran on "
                             f"{state['branch']}")
    check_composition(f"Proteus (struct2seq) + FrameDiff OR, length {n}, {steps} steps, "
                      f"esm_rate {rate}", out, n, "OR")
    dts = np.diff(state["stamps"]) * 1e3
    s2s_ms = [d for i, d in enumerate(dts) if i in gate]
    plain_ms = [d for i, d in enumerate(dts) if i not in gate]
    log(f"  the branch ran on steps {state['branch']} (the gate's {gate}) and no other; "
        f"ms per step (synced): struct2seq steps {np.median(s2s_ms):.3f} median "
        f"({', '.join(f'{d:.3f}' for d in s2s_ms)}), plain steps {np.median(plain_ms):.3f} "
        f"median ({min(plain_ms):.3f}-{max(plain_ms):.3f}); {dts.sum() / 1e3:.3f} s in all; "
        f"peak {peak:.3f} GiB above the {base / 2**30:.3f} GiB held")
    del proteus, framediff, s2s, out
    torch.cuda.empty_cache()


def synthetic_pdb_family(directory, count, n, seed):
    """``count`` helices of ``n`` residues (100 degrees and 1.5 A a residue
    along a straight axis from the origin, each with its own radius and
    noise, drawn from ``seed``; at 128 residues the axis reaches 190 A, past
    the 100 A that the writer's columns held before they kept the PDB
    layout), written as PDB files by the port's writer; returns their
    paths."""
    import numpy as np
    import torch

    from superdiff_tpu_torch.models.protein import backbone, rigid

    rng = np.random.default_rng(seed)
    paths = []
    for k in range(count):
        idx = np.arange(n)
        theta = idx * np.deg2rad(100.0 + rng.normal(0, 3))
        r = 2.3 + rng.normal(0, 0.1)
        trans = np.stack([r * np.cos(theta), r * np.sin(theta), 1.5 * idx], -1)
        trans += 0.3 * rng.standard_normal(trans.shape)
        rotvec = 0.3 * rng.standard_normal((n, 3)) + np.stack(
            [np.zeros(n), np.zeros(n), theta], -1)
        quat = rigid.rotmat_to_quat(rigid.rotvec_to_rotmat(
            torch.as_tensor(rotvec, dtype=torch.float32)))
        rigids = rigid.rigid(quat, torch.as_tensor(trans, dtype=torch.float32))
        path = Path(directory) / f"helix_{k:03d}.pdb"
        path.write_text(backbone.to_pdb(backbone.to_atom37(rigids[None])[0]))
        paths.append(path)
    return paths


def se3_training(se3, dev, args):
    """``FrameDiffScoreNetwork`` at ``FrameDiffConfig()`` (node 256, edge 128,
    4 IPA blocks, 8 heads) trained by ``make_train_step`` with
    ``make_se3_dsm_loss`` (Adam lr 1e-4, warmup 100, EMA 0.999) for 20 steps
    of batch 8 at length 128 on a synthetic helix family written as PDB files
    and read back through ``ProteinDataset``: loss finite, parameters and
    EMA moved; ms per step, peak memory, then the device's idle share over 3
    profiled steps."""
    import tempfile

    import numpy as np
    import torch

    from superdiff_tpu_torch.data.pdb import ProteinDataset, ProteinDatasetConfig
    from superdiff_tpu_torch.models.from_jax import init_like_flax_
    from superdiff_tpu_torch.models.protein.framediff import FrameDiffConfig, \
        FrameDiffScoreNetwork
    from superdiff_tpu_torch.train import se3_trainer, trainer

    n, b, count = 128, 8, 32
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synthetic_pdb_family(tmp, count, n, args.seed)
        ds = ProteinDataset.from_dir(tmp, ProteinDatasetConfig(min_len=20, max_len=512))
        log(f"  {count} synthetic helices of {n} residues written as PDB files and read back "
            f"by ProteinDataset: {len(ds)} structures, padded to {ds.pad_to}; "
            f"{time.perf_counter() - t0:.2f} s")
    if len(ds) != count or ds.pad_to != n:
        raise AssertionError(f"ProteinDataset read {len(ds)} structures padded to {ds.pad_to}")
    with torch.device(dev):
        net = FrameDiffScoreNetwork(FrameDiffConfig(), score_calc=se3)
    init_like_flax_(net, torch.Generator(device=dev).manual_seed(args.seed))
    opt = trainer.make_optimizer(lr=1e-4, warmup=100)
    state = trainer.init_train_state(torch.Generator(device=dev).manual_seed(args.seed + 1),
                                     net, opt, ema_rate=0.999)
    step = trainer.make_train_step(opt, se3_trainer.make_se3_dsm_loss(net, se3))
    p0 = {k: v.detach().clone() for k, v in net.named_parameters()}
    ema0 = {k: v.clone() for k, v in state.params_ema.items()}
    rng = np.random.default_rng(args.seed)

    def batch():
        return {k: torch.as_tensor(v, device=dev)
                for k, v in ds.batch(rng.choice(len(ds), b, replace=False)).items()}

    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for i in range(20):
        x = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, x)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    moved = sum(not torch.equal(p0[k], v) for k, v in net.named_parameters())
    ema_moved = sum(not torch.equal(ema0[k], v) for k, v in state.params_ema.items())
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  FrameDiff {n_params / 1e6:.3f} M parameters, batch {b}, length {n}, 20 steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (all finite: {bool(np.isfinite(losses).all())}); "
        f"{moved} of {len(p0)} parameter tensors and {ema_moved} EMA tensors moved; ms per step "
        f"(synced, the loss read) median of the last 18 {np.median(ms[2:]):.3f} "
        f"({min(ms[2:]):.3f}-{max(ms[2:]):.3f}), first {ms[0]:.1f}; peak {peak:.3f} GiB above "
        f"the {base / 2**30:.3f} GiB held")
    if not np.isfinite(losses).all() or moved == 0 or ema_moved == 0:
        raise AssertionError("SE(3) training: a loss not finite, or parameters / EMA unmoved")
    x = batch()
    fams, wall, _ = profile_by_family(lambda: [step(state, x) for _ in range(3)],
                                      OUT / "chip_smoke_se3_train_profile.txt", cycles=1,
                                      cpu=False)
    total = sum(fams.values())
    log(f"  profile (3 train steps): {total / 3:.3f} ms device time per step, {wall / 3:.3f} ms "
        f"wall per step under the profiler (device idle {1 - total / wall:.3f}); by family "
        f"(ms per step): " + ", ".join(
            f"{k} {v / 3:.4f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])[:6]))
    del net, state
    torch.cuda.empty_cache()


def write_cifar10(root, n_per_batch, seed):
    """A small CIFAR-10 stand-in in the ``cifar-10-batches-py`` layout
    (five training batches and a test batch of ``n_per_batch`` images drawn
    from ``seed``)."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    d = Path(root) / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n_per_batch, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n_per_batch).tolist()}, f)


def cli_on_card(dev, args):
    """``cli sd --preset tiny`` (2 steps) and ``cli cifar`` at a tiny config
    (``CONFIGS['vpsde']`` swapped for it in this process): 4 train steps,
    then ``fid_stats`` of a small CIFAR-10 stand-in with seed-drawn
    Inception weights; both on the card (the commands' default device), each
    writing its outputs."""
    import os
    import tempfile

    import numpy as np
    import torch

    from superdiff_tpu_torch import cli
    from superdiff_tpu_torch.pipelines import cifar

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli.main(["sd", "--preset", "tiny", "--num_inference_steps", "2",
                  "--out_dir", f"{tmp}/sd"])
        torch.cuda.synchronize()
        img_dir = Path(tmp) / "sd" / "and" / "a_cat_and_a_dog"
        with np.load(img_dir / "latents.npz") as f:
            lat = f["latents"]
        images = sorted(p.name for p in img_dir.iterdir() if p.name != "latents.npz")
        log(f"  cli sd --preset tiny --num_inference_steps 2 (and, batch 6, 512 px): "
            f"{time.perf_counter() - t0:.1f} s; latents {lat.shape} finite "
            f"{bool(np.isfinite(lat).all())}; images {images}")
        if not np.isfinite(lat).all() or not images:
            raise AssertionError("cli sd wrote no finite latents or no images")

        tiny = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                    batch_size=16, log_every=1, save_every=4, eval_batch_size=25,
                    image_size=32)
        saved = cifar.CONFIGS["vpsde"]
        cifar.CONFIGS["vpsde"] = lambda: cifar.CifarConfig(**tiny)
        write_cifar10(f"{tmp}/data", 50, args.seed)
        os.environ["SUPERDIFF_DATA_DIR"] = f"{tmp}/data"
        try:
            t0 = time.perf_counter()
            cli.main(["cifar", "--mode", "train", "--config", "vpsde", "--n_iters", "4",
                      "--workdir", f"{tmp}/cifar"])
            recs = [json.loads(x) for x in
                    (Path(tmp) / "cifar" / "metrics.jsonl").read_text().splitlines()]
            ckpts = sorted(os.listdir(Path(tmp) / "cifar" / "checkpoints"))
            log(f"  cli cifar --mode train (tiny config, 4 steps): "
                f"{time.perf_counter() - t0:.1f} s; losses "
                f"{[round(r['loss'], 4) for r in recs]}; checkpoints {ckpts}")
            if len(recs) != 4 or not np.isfinite([r["loss"] for r in recs]).all() \
                    or ckpts != ["chkpt_4.pt"]:
                raise AssertionError("cli cifar train: records or checkpoint missing")
            inception_npz(Path(tmp) / "inception.npz", args.seed)
            t0 = time.perf_counter()
            cli.main(["cifar", "--mode", "fid_stats", "--config", "vpsde", "--workdir",
                      f"{tmp}/cifar", "--inception_weights", f"{tmp}/inception.npz"])
            stats = {}
            for split in ("train", "test"):
                with np.load(Path(tmp) / "cifar" / "assets" / "stats"
                             / f"cifar10_{split}_stats.npz") as f:
                    stats[split] = f["pool_3"]
            log(f"  cli cifar --mode fid_stats (a 300-image CIFAR-10 stand-in): "
                f"{time.perf_counter() - t0:.1f} s; pool_3 "
                + ", ".join(f"{k} {v.shape}" for k, v in stats.items()))
            if not all(np.isfinite(v).all() and v.shape[1] == 2048 for v in stats.values()):
                raise AssertionError("cli cifar fid_stats: bad statistics")
        finally:
            cifar.CONFIGS["vpsde"] = saved
            del os.environ["SUPERDIFF_DATA_DIR"]
    expect_counts("the CLI runs (plain paths)", read_counts())


def struct2seq_training_phase(dev, args):
    """Phase 8: struct2seq-conditioned composition, SE(3) training and the
    ``sd`` / ``cifar`` commands, each at the sizes its docstring gives."""
    import torch

    from superdiff_tpu_torch.models.protein import SE3Diffuser

    log(f"  card: {card_line()}")
    se3 = SE3Diffuser.default(device=dev)
    log_phase("  struct2seq-conditioned composition")
    struct2seq_composition(se3, dev, args)
    log_phase("  SE(3) training")
    se3_training(se3, dev, args)
    log_phase("  the cifar and sd commands")
    zero_counts()
    cli_on_card(dev, args)
    torch.cuda.empty_cache()
    log_phase("  phase 8 done")

# phase 9's sizes: full SD-1.x at 512 px, FLD at the notebook's protocol
# size, the 2-D walkthrough as the example runs it
NLL_HW, NLL_BATCH, NLL_STEPS, NLL_GUIDANCE = 512, 2, 10, 7.5
NLL_PLAIN_TOL = 5e-2
# the round trip's latents against plain torch: 9.6e-2 relative L2 on an
# NVIDIA H100 80GB HBM3 at 700 W (10 + 10 steps, seed 0); the check prints
# the first-order figure beside it; a kernel fault moves them by O(1)
NLL_ROUNDTRIP_TOL = 0.25
FLD_SIZES = (10_000, 50_000, 10_000, 768)  # generated, train, test, feature dim
FLD_CHECK_SIZES = (500, 2_500, 500)
FLD_REPEATS = 3  # fld_repeated's subsets (the notebook takes 10)
FLD_TOL = 1e-4
WALK_ITERS, WALK_STEPS, WALK_SAMPLES = 2000, 400, 512
NCSN_TOL = 1e-4


def nll_modules(dev, seed):
    """The SD-1.x stack (random bf16 weights from ``seed``) and a VAEEncoder
    of the same widths (seed + 1)."""
    import torch

    from superdiff_tpu_torch.models.from_jax import init_like_flax_
    from superdiff_tpu_torch.models.sd.vae import VAEConfig, VAEEncoder
    from superdiff_tpu_torch.pipelines import sd

    mod = sd.build_sd_modules(seed, device=dev, dtype=torch.bfloat16)
    with torch.device(dev):
        enc = VAEEncoder(VAEConfig(), dtype=torch.bfloat16)
    init_like_flax_(enc, torch.Generator(device=dev).manual_seed(seed + 1))
    return sd, mod, enc.eval().requires_grad_(False)


def unet_velocity(unet):
    """``vel_fn(x, t, sigma, c)`` of the reference's ``get_ll_ode``: the
    UNet's epsilon at the sigma-scaled input."""
    import torch

    def vel(x, t, sigma, c):
        return unet(x / torch.sqrt(sigma**2 + 1.0), t.to(x.device), c)

    return vel


def expect_families(what, most, **want):
    """Kernels on the device by family (``profile_by_family``'s agreed count)."""
    got = {fam: most.get(fam, 0) for fam in want}
    log(f"  {what}: kernels on the device (profiler) " +
        ", ".join(f"{k} {v}" for k, v in got.items()))
    if got != want:
        raise AssertionError(f"{what}: kernels on the device {got} != {want}")


def nll_phase(dev, args):
    """9a: ``eval.nll.ode_nll`` through the full SD-1.x UNet (bf16, random
    weights) at 512 px, latent batch 2, on ``SigmaGrid.euler_discrete(10)``
    (the reference's 1000 steps cut to 10 each way): a seed-drawn uint8
    batch through the ``VAEEncoder`` (its mean times the latent scale, as
    ``get_ll_ode`` encodes), unguided and with guidance 7.5. Outputs finite;
    every UNet primal launches 10 ``flash_mha_eod`` and 16
    ``geglu_ffn_block`` (wrapper counts over both runs, and kernels on the
    device over the unguided run on a one-step grid); against its twin with every attention and
    FFN in plain torch (``attn_impl`` / ``ffn_impl`` ``"einsum"``) on the
    card: one UNet forward at the encoded latents within ``NLL_PLAIN_TOL``
    relative L2 (phase 3e's tolerance for one forward), the unguided run's
    ``ll`` within ``NLL_PLAIN_TOL`` of |ll| and its ``latents_end`` within
    ``NLL_ROUNDTRIP_TOL`` relative L2. The round trip multiplies each
    forward's bf16 rounding by the sigma it spans: to first order the
    latents move by sum |dsigma| (29.2 over the grid, whatever its step
    count) times the forward's error times |v| / |latents_end|, and this
    first-order figure is printed beside the distance. Then 9d's trace of
    one step."""
    import torch

    from superdiff_tpu_torch.core import ito
    from superdiff_tpu_torch.core.schedules import SigmaGrid
    from superdiff_tpu_torch.eval import nll
    from superdiff_tpu_torch.utils import profiling, traceparse

    t0 = time.perf_counter()
    sd, mod, enc = nll_modules(dev, args.seed)
    torch.cuda.synchronize()
    log(f"  SD stack and VAEEncoder (random bf16 weights): {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=dev).manual_seed(args.seed + 9)
    images = torch.randint(0, 256, (NLL_BATCH, NLL_HW, NLL_HW, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    with torch.no_grad():
        moments = enc(images.float() / 127.5 - 1.0)
        lat = moments[..., :moments.shape[-1] // 2] * mod.vae_scaling
        ctx_obj = sd.encode_prompts(mod, ["a photo of a cat"] * NLL_BATCH)
        ctx_unc = sd.encode_prompts(mod, [""] * NLL_BATCH)
    del enc
    finite("encoded latents", lat)
    grid, n = SigmaGrid.euler_discrete(NLL_STEPS), NLL_STEPS
    probes = ito.rademacher((2 * n,) + tuple(lat.shape), g, lat.dtype, dev)
    vel = unet_velocity(mod.unet)
    guidance = (ctx_obj, ctx_unc, NLL_GUIDANCE)

    def run(velocity=vel, guided=False, grid=grid, probes=probes):
        return nll.ode_nll(velocity, ctx_obj, lat, grid, probes=probes,
                           guidance=guidance if guided else None)

    float(run(grid=SigmaGrid.euler_discrete(1), probes=probes[:2])["ll"].sum())  # warmup
    outs = {}
    for guided in (False, True):
        name = "guided" if guided else "unguided"
        primals = 2 * n * (2 if guided else 1)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(guided=guided)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(f"ode_nll {name}, {n} + {n} steps ({primals} UNet primals)",
                      read_counts(), flash_mha_eod=10 * primals, geglu_ffn_block=16 * primals)
        finite(f"ode_nll {name}", *(out[k] for k in ("ll", "ll_path", "ll_base",
                                                      "latents_end")))
        log(f"  ode_nll {name}: {wall:.3f} s, {wall * 1e3 / (2 * n):.1f} ms per NLL step, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; ll "
            f"{[round(v, 3) for v in out['ll'].tolist()]} (path "
            f"{[round(v, 3) for v in out['ll_path'].tolist()]}, base "
            f"{[round(v, 3) for v in out['ll_base'].tolist()]})")
        outs[name] = out
    plain = with_attn_impl(sd, mod, "einsum", ffn_impl="einsum")
    sigma0, t_0 = grid.sigmas[-2], torch.tensor(grid.timesteps[-1])
    sig = torch.tensor(sigma0)
    with torch.no_grad():
        v, v_ref = (unet_velocity(u)(lat, t_0, sig, ctx_obj) for u in (mod.unet, plain.unet))
    err_fwd = rel_l2(v, v_ref)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = run(velocity=unet_velocity(plain.unet))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_counts("ode_nll unguided, plain torch throughout", read_counts())
    got = outs["unguided"]
    err_lat = rel_l2(got["latents_end"], ref["latents_end"])
    err_ll = ((got["ll"] - ref["ll"]).abs().max() / ref["ll"].abs().max()).item()
    span = sum(abs(a - b) for a, b in zip(grid.sigmas[:-1], grid.sigmas[1:])) * 2
    first_order = span * err_fwd * (v_ref.norm() / ref["latents_end"].norm()).item()
    log(f"  against plain torch: one UNet forward relative L2 {err_fwd:.3e} (tol "
        f"{NLL_PLAIN_TOL}); the unguided run ({wall:.3f} s) latents_end relative L2 "
        f"{err_lat:.3e} (tol {NLL_ROUNDTRIP_TOL}; first order {first_order:.3e}: sum |dsigma| "
        f"{span:.2f} x the forward's error x |v| / |latents_end|), ll {err_ll:.3e} of |ll| "
        f"(tol {NLL_PLAIN_TOL})")
    if not (err_fwd < NLL_PLAIN_TOL and err_ll < NLL_PLAIN_TOL
            and err_lat < NLL_ROUNDTRIP_TOL):
        raise AssertionError(f"ode_nll against plain torch: forward {err_fwd}, latents "
                             f"{err_lat}, ll {err_ll}")
    del plain, ref, v, v_ref
    one, p1 = SigmaGrid.euler_discrete(1), probes[:2]
    # with the host's activity, which filters the records a cycle is handed
    # from the run before; a card-only profile of the guided step lost 15 %
    # of its kernel records in both of its cycles (an H100 80GB HBM3 at
    # 700 W), and a host-recorded one is the slowest part of the phase, so
    # the guided run's launches are its wrappers' counts above
    # no warm-up runs between the three recorded ones (the step has run
    # before): the median of three covers a record the tracer drops
    _, _, most = profile_by_family(lambda: run(grid=one, probes=p1),
                                   OUT / "chip_smoke_nll_profile.txt", warmup=0)
    expect_families("ode_nll unguided, one step each way (2 UNet primals)", most,
                    **{EOD: 20, "geglu_ffn_block": 96})
    log_phase("  9d: one NLL step under utils.profiling.trace, read by utils.traceparse")
    with tempfile.TemporaryDirectory() as logdir:  # the trace is read here, not kept
        with profiling.trace(logdir, host=False) as prof:
            run(grid=one, probes=p1)
            torch.cuda.synchronize()
        per_op = traceparse.load_device_ops(logdir)
    fams, total_us = traceparse.categorize(per_op)
    prof_us = 1e3 * sum(ms for *_, ms, _ in device_kernels(prof.key_averages()))
    log(f"  trace: {total_us / 1e3:.3f} ms of device time in {len(per_op)} kernel names; "
        f"the profiler's {prof_us / 1e3:.3f} ms; families " +
        ", ".join(f"{k} {v / 1e3:.3f}" for k, v in fams.most_common()))
    if not (total_us > 0 and abs(total_us - prof_us) <= 0.01 * prof_us):
        raise AssertionError(f"traceparse families {total_us} us != profiler {prof_us} us")
    stats = profiling.device_memory_stats()
    peak = stats["cuda:0"]["allocated_bytes.all.peak"]
    log(f"  device_memory_stats: peak {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f})")
    if peak != torch.cuda.max_memory_allocated():
        raise AssertionError(f"device_memory_stats peak {peak} != max_memory_allocated")
    del mod, outs, got
    torch.cuda.empty_cache()


def fld_phase(dev, args):
    """9b: FLD at the notebook's protocol size on seed-drawn features
    (DINOv2's weights are not in the repository): generated 10 000, train
    50 000, test 10 000, d 768, anisotropic Gaussians, the generated set
    shifted by 0.05; ``fld`` (200 Adam steps), ``fld_repeated`` (x3,
    subsets of 10 000; the notebook takes 10). The card against the
    port's own CPU ``fld`` on the first 500 / 2 500 / 500 rows (TF32
    off) within ``FLD_TOL`` relative, the tolerance of the CPU tests
    against JAX."""
    import torch

    from superdiff_tpu_torch.eval import fld

    ng, ntr, nte, d = FLD_SIZES
    g = torch.Generator(device=dev).manual_seed(args.seed + 21)
    scale = torch.rand(d, generator=g, device=dev) + 0.5
    draw = lambda rows, shift=0.0: torch.randn(rows, d, generator=g, device=dev) * scale + shift
    train, test, gen = draw(ntr), draw(nte), draw(ng, 0.05)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = fld.fld(gen, train, test, device=dev)
    log(f"  fld ({ng} / {ntr} / {nte}, d {d}): {val:.6f} in {time.perf_counter() - t0:.2f} s")
    if not math.isfinite(val):
        raise AssertionError(f"fld: {val}")
    t0 = time.perf_counter()
    mean, std = fld.fld_repeated(gen, train, test, n_repeats=FLD_REPEATS, device=dev)
    log(f"  fld_repeated (x{FLD_REPEATS}, subsets of 10 000): {mean:.6f} +- {std:.6f} in "
        f"{time.perf_counter() - t0:.2f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    if not (math.isfinite(mean) and math.isfinite(std)):
        raise AssertionError(f"fld_repeated: {mean} +- {std}")
    a, b, c = FLD_CHECK_SIZES
    sub = (gen[:a], train[:b], test[:c])
    card = fld.fld(*sub, device=dev)
    t0 = time.perf_counter()
    cpu = fld.fld(*(x.cpu() for x in sub), device="cpu")
    rel = abs(card - cpu) / abs(cpu)
    log(f"  fld {a} / {b} / {c}: card {card:.7f}, CPU {cpu:.7f} ({time.perf_counter() - t0:.1f} s"
        f" on the CPU): relative {rel:.3e} (tol {FLD_TOL})")
    if not rel <= FLD_TOL:
        raise AssertionError(f"fld card {card} vs CPU {cpu}")
    del train, test, gen, sub
    torch.cuda.empty_cache()


def walkthrough_phase(dev, args):
    """9c: the 2-D walkthrough as ``python -m
    superdiff_tpu_torch.examples.superposition_2d`` runs it: two MLP score
    nets (hidden (128, 128)) trained 2000 iterations each at batch 256,
    then ``or_sde``, ``or_ode``, ``avg_sde`` over 400 steps on 512 samples.
    ``or_sde`` (the captured step loop) must put 0.4-0.6 of its samples in
    the upper modes and 0.95 or more within 1 of a centre (the CPU run:
    0.47-0.50 and 0.98 over four seeds), launch 1 ``fused_sde_step`` per
    step (the wrappers: step 0 and the capture; the device: the
    profiler over recorded first calls), and the other two no kernel."""
    import torch

    from superdiff_tpu_torch.examples import superposition_2d as s2d

    models = []
    for seed, which in enumerate(("up", "down")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models.append(s2d.train_model(which, WALK_ITERS, seed=seed, device=dev,
                                      log=lambda m: log(f"  {m}")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  train_model({which!r}, {WALK_ITERS}): {wall:.2f} s "
            f"({wall * 1e3 / WALK_ITERS:.3f} ms per iteration)")
    x1 = torch.randn((WALK_SAMPLES, 2), generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev)
    for name in s2d.COMPOSITIONS:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0, logq, nfe = s2d.sample(models, name, x1, n_steps=WALK_STEPS,
                                   generator=torch.Generator(device=dev).manual_seed(8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(f"{name}, {WALK_STEPS} steps", read_counts(),
                      **({"fused_sde_step": 2} if name == "or_sde" else {}))
        finite(name, x0, logq)
        up, near = s2d.up_fraction(x0), s2d.near_centre_fraction(x0)
        log(f"  {name}: {wall:.3f} s ({wall * 1e3 / WALK_STEPS:.3f} ms per step), nfe {nfe}; "
            f"up-mode fraction {up:.4f}, within 1 of a centre {near:.4f}")
        if name == "or_sde" and not (0.4 <= up <= 0.6 and near >= 0.95):
            raise AssertionError(f"or_sde modes: up {up}, near {near}")
    counted_runs(f"2-D or_sde, {WALK_STEPS} steps",
                 lambda: s2d.sample(models, "or_sde", x1, n_steps=WALK_STEPS,
                                    generator=torch.Generator(device=dev).manual_seed(8)),
                 WALK_STEPS, fused_sde_step=1)


def ncsn_card_against_cpu(dev, seed):
    """9d: every NCSN norm and block, plain and conditional, on the card
    against the same module on the CPU, fp32 (TF32 off), at odd spatial
    sizes, fusions that grow and shrink: within ``NCSN_TOL`` of the largest
    output."""
    import copy
    import functools

    import torch

    from superdiff_tpu_torch.models import ncsn_layers as L
    from superdiff_tpu_torch.models import normalization as N

    torch.manual_seed(seed)
    cond = functools.partial(N.ConditionalInstanceNorm2dPlus, num_classes=10)
    c, h, w = 32, 33, 31
    x, x2 = torch.randn(4, c, h, w), torch.randn(4, 16, 17, 16)
    y = torch.randint(0, 10, (4,))
    cases = {
        "VarianceNorm2d": (N.VarianceNorm2d(c, bias=True), (x,)),
        "InstanceNorm2d": (N.InstanceNorm2d(c), (x,)),
        "InstanceNorm2dPlus": (N.InstanceNorm2dPlus(c), (x,)),
        "ConditionalInstanceNorm2dPlus": (cond(c), (x, y)),
        "GroupNorm": (N.get_normalization("GroupNorm")(c), (x,)),
        "CRPBlock": (L.CRPBlock(c), (x,)),
        "CondCRPBlock": (L.CondCRPBlock(c, cond), (x, y)),
        "RCUBlock": (L.RCUBlock(c), (x,)),
        "CondRCUBlock": (L.CondRCUBlock(c, cond), (x, y)),
        "MSFBlock (grow)": (L.MSFBlock([c, 16], (h, w), c), ([x, x2],)),
        "MSFBlock (shrink)": (L.MSFBlock([c, 16], (12, 11), c), ([x, x2],)),
        "CondMSFBlock": (L.CondMSFBlock([c, 16], (h, w), c, cond), ([x, x2], y)),
        "RefineBlock (end)": (L.RefineBlock([c, 16], (h, w), c, end=True), ([x, x2],)),
        "CondRefineBlock (start)": (L.CondRefineBlock([c], (h, w), c, cond, start=True),
                                    ([x], y)),
        "ConvMeanPool": (L.ConvMeanPool(c, 16), (x[:, :, :32, :30],)),
        "MeanPoolConv": (L.MeanPoolConv(c, 16), (x[:, :, :32, :30],)),
    }
    to_dev = lambda a: [t.to(dev) for t in a] if isinstance(a, list) else a.to(dev)
    worst = 0.0
    with torch.no_grad():
        for name, (m, inputs) in cases.items():
            m.eval()
            ref = m(*inputs)
            got = copy.deepcopy(m).to(dev)(*(to_dev(a) for a in inputs)).cpu()
            err = (got - ref).abs().max().item() / ref.abs().max().item()
            worst = max(worst, err)
            if got.shape != ref.shape or not err <= NCSN_TOL:
                raise AssertionError(f"{name}: card vs CPU {err} (tol {NCSN_TOL})")
    log(f"  {len(cases)} NCSN norms and blocks, card vs CPU (fp32): worst {worst:.3e} of the "
        f"largest output (tol {NCSN_TOL})")


def aggregate_without_pandas():
    """9d: ``eval.aggregate`` over a CSV tree in a temporary directory (the
    card's machine has no pandas)."""
    import csv

    from superdiff_tpu_torch.eval import aggregate

    rows = {"and": [(1.0, 3.0, 1.0), (2.0, 1.0, 1.0)], "sd_ab": [(0.3, 0.2, 0.2), (0.9, 0.7, 0.7)],
            "sd_ba": [(0.2, 0.6, 0.2), (0.5, 0.5, 0.5)]}
    with tempfile.TemporaryDirectory() as root:
        for method, table in rows.items():
            d = Path(root) / f"metrics_{method}"
            d.mkdir()
            with open(d / f"metrics_{method}_pair.csv", "w", newline="") as fh:
                wr = csv.writer(fh)
                wr.writerow(["clip_raw_score_1", "clip_raw_score_2", "min_clip"])
                wr.writerows(table)
        out = aggregate.summarize_methods(root, list(rows))
    want_and = (1.0 + 1.0) / 2
    got_and = out["methods"][0]["min_mean"]
    jb = out["joint_baseline"]
    log(f"  eval.aggregate: {len(out['methods'])} methods, and min_mean {got_and}, joint "
        f"{jb['joint']}; pandas imported: {'pandas' in sys.modules}")
    if got_and != want_and or jb["joint"] != (0.2 + 0.7) / 2:
        raise AssertionError(f"eval.aggregate: {out}")


def phase9(dev, args):
    """Phase 9: the SD likelihood, FLD, the 2-D walkthrough and the
    utilities on the card (9a-9d), at the sizes their docstrings give."""
    import torch

    log(f"  card: {card_line()}")
    t_all = time.perf_counter()
    for title, fn in (("9a: SD ODE likelihood (512 px, latent batch 2, 10 + 10 steps)",
                       lambda: nll_phase(dev, args)),
                      ("9b: FLD (10 000 / 50 000 / 10 000, d 768)", lambda: fld_phase(dev, args)),
                      ("9c: the 2-D walkthrough (2 x 2000 iterations, 3 x 400 steps)",
                       lambda: walkthrough_phase(dev, args)),
                      ("9d: the NCSN layers on the card, eval.aggregate without pandas",
                       lambda: (ncsn_card_against_cpu(dev, args.seed),
                                aggregate_without_pandas()))):
        log_phase(f"  {title}")
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        log(f"  ({time.perf_counter() - t0:.1f} s)")
    log_phase(f"  phase 9 done ({time.perf_counter() - t_all:.1f} s)")


# ---------------------------------------------------------------------------
# phase 10: the parallel tier, one process per card

P10_TRAIN_STEPS, P10_CIFAR_STEPS, P10_SD_STEPS = 10, 20, 2
P10_PROFILE_STEPS = 5  # the steps of 10b's profiled runs
P10_SD_HW = 512  # SD (10c) and the TP forward (10d)
P10_RING_SHAPE = (24, 4096, 8, 40)  # (B, L, H, D)
P10_PP_SHAPE = (16, 128)  # (batch, length) through the seq-transformer stages


def rank_device():
    """This rank's card (``parallel.distributed.initialize`` bound it)."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def p10_unet_config():
    """The TP forward's UNet: SD-1.x's published widths on the einsum
    lowering."""
    from superdiff_tpu_torch.models.sd.unet import SDUNetConfig

    return SDUNetConfig(attn_impl="einsum", ffn_impl="einsum")


def phase10(args):
    """Phase 10: the parallel tier on every visible card, one process a
    card (``torch.multiprocessing``, start method spawn), NCCL over a
    localhost rendezvous at a free port; world size W = the card count (1
    on the one-card machine: NCCL, the process groups and every collective
    still run, at size 1). A rank that raises fails the phase: the others
    are stopped and the error goes up."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from superdiff_tpu_torch.ops import _build

    log(f"  card: {card_line()}")
    _build.build_all()  # once here, not in W processes at once
    world = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.start_processes(phase10_rank, args=(world, port, args), nprocs=world,
                       start_method="spawn", join=True)
    log_phase(f"  phase 10 done, W = {world} ({time.perf_counter() - t0:.1f} s in the ranks)")


def phase10_rank(rank, world, port, args):
    """One rank of phase 10: (a)-(f) in turn; rank 0 prints every rank's
    figures, gathered after each run."""
    import torch
    import torch.distributed as dist

    from superdiff_tpu_torch.parallel import distributed as D

    t_start = time.perf_counter()
    D.initialize(f"127.0.0.1:{port}", world, rank, device="cuda")
    dev = rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank == 0:
        log(f"  W = {world}: {world} process(es), process group up in "
            f"{time.perf_counter() - t_start:.1f} s")
    for title, fn in (
            (f"10a: DP training, vpsde_less_5 (nf 128, batch 128 global, bf16), "
             f"{P10_TRAIN_STEPS} steps", p10_train),
            (f"10b: CIFAR joint sampler (vpsdeA, 2 models, batch 100), score_mode vmap on "
             f"model = min(2, W), {P10_CIFAR_STEPS} sde/or steps", p10_cifar),
            (f"10c: SD or, 512 px, latent batch 8 over data, {P10_SD_STEPS} steps", p10_sd),
            ("10d: TP SD-1.x UNet forward, 512 px, einsum lowering, fp32, tp = W", p10_tp),
            ("10e: ring attention (24, 4096, 8, 40), fp32 and bf16", p10_ring),
            ("10f: pipeline of FrameDiffConfig()'s seq-transformer layers, W stages",
             p10_pipeline)):
        if rank == 0:
            log_phase(f"  {title}")
        t0 = time.perf_counter()
        zero_counts()
        figures = fn(rank, world, dev, args)
        torch.cuda.empty_cache()
        every = [None] * world
        dist.all_gather_object(every, figures)
        if rank == 0:
            for r, f in enumerate(every):
                log(f"    rank {r}: " + "; ".join(f"{k} {v}" for k, v in f.items()))
            log(f"    ({time.perf_counter() - t0:.1f} s)")
    dist.barrier()
    dist.destroy_process_group()


def p10_expect(what, got, **want):
    """:func:`expect_counts` on this rank (the message names it)."""
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: launch counts {got} != {want}")
    return {k: v for k, v in got.items() if v}


def p10_train(rank, world, dev, args):
    """DP training: the same global batches and eps through
    ``make_train_step(mesh=make_mesh(model=1))`` and, on every rank, through
    the one-process step. The DP state is bit-identical across ranks
    (rank 0's broadcast); against the one-process run the loss is within
    rtol 1e-2 (bf16 forwards at another batch size take other cuDNN
    algorithms, and cuDNN's weight gradients are not deterministic, W = 1
    included) and every parameter within 2 x the learning rates summed (one
    Adam update moves a parameter by at most about its rate)."""
    import statistics

    import torch

    from superdiff_tpu_torch.core.dsm import make_dsm_loss
    from superdiff_tpu_torch.core.schedules import VPSchedule
    from superdiff_tpu_torch.parallel import mesh as M
    from superdiff_tpu_torch.pipelines import cifar
    from superdiff_tpu_torch.train import make_optimizer, make_train_step

    cfg = cifar.CONFIGS["vpsde_less_5"]()
    mesh = M.make_mesh(model=1)
    n, i = M.data_sharding(mesh)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, cfg.num_channels)
    batches = [{"image": torch.rand(shape, generator=g, device=dev) * 2 - 1}
               for _ in range(P10_TRAIN_STEPS)]
    eps = [torch.randn(shape, generator=g, device=dev) for _ in range(P10_TRAIN_STEPS)]
    runs = {}
    for dp in (True, False):
        state, _, _ = fresh_train_state(cfg, dev, args.seed)
        model = state.model
        model.shard_dropout(*((n, i) if dp else (1, 0)))
        loss_fn = make_dsm_loss(cifar._apply_fn(model), VPSchedule(),
                                num_shards=n if dp else 1, shard_index=i if dp else 0)
        opt = make_optimizer(cfg.lr, cfg.warmup, grad_clip=cfg.grad_clip)
        step = make_train_step(opt, loss_fn, mesh=mesh if dp else None)
        losses, ms = [], []
        for b, e in zip(batches, eps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, b, eps=e)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        runs[dp] = (state, losses, statistics.median(ms[2:]))
    state, losses, step_ms = runs[True]
    ref, ref_losses, ref_ms = runs[False]
    flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()] +
                     [v.reshape(-1) for v in state.params_ema.values()])
    mine = flat.clone()
    torch.distributed.broadcast(flat, 0)
    same = (torch.equal(flat, mine), state.step == P10_TRAIN_STEPS + 1)
    if not all(same):
        raise AssertionError(f"rank {rank}: the DP state differs from rank 0's: {same}")
    lrs = [cfg.lr * min(s / cfg.warmup, 1.0) for s in range(P10_TRAIN_STEPS)]
    bound = 2 * sum(lrs)
    dp_err = max((p - q).abs().max().item() for p, q in
                 zip(state.model.parameters(), ref.model.parameters()))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if not (loss_err <= 1e-2 and dp_err <= bound and all(map(math.isfinite, losses))):
        raise AssertionError(f"rank {rank}: DP vs one process: loss rel {loss_err}, params "
                             f"{dp_err} (bound {bound})")
    # the step's all-reduce alone: the flattened gradients (and the loss)
    buf = torch.zeros(sum(p.numel() for p in state.model.parameters()) + 1, device=dev)
    ar_ms = time_ms(lambda: mesh.all_reduce(buf, "data"), budget_ms=100.0)
    return {"DP step ms": round(step_ms, 3), "one-process step ms": round(ref_ms, 3),
            "all-reduce ms": round(ar_ms, 4), "all-reduce share": round(ar_ms / step_ms, 4),
            "losses": [round(v, 4) for v in losses[:3]],
            "loss rel err": f"{loss_err:.2e}", "param max err": f"{dp_err:.3e} (bound "
            f"{bound:.2e})", "state": "bit-identical to rank 0's"}


def p10_profiled(run, cycles=3):
    """The median over ``cycles`` profiled runs of the kernels each family
    launched (:func:`agreed`), each after an unrecorded run; the card's
    activity alone (a host-recorded trace of the eager vmap steps is slow to
    read back), so a cycle keeps every record (:func:`recorded_kernels`)
    and the median rules out a stray one."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=cycles),
                 on_trace_ready=lambda p: traced.append(recorded_kernels(p))) as prof:
        for _ in range(2 * cycles):
            run()
            torch.cuda.synchronize()
            prof.step()
    runs = []
    for kernels in traced:
        seen = {}
        for fam, _, _, n in kernels:
            seen[fam] = seen.get(fam, 0) + n
        runs.append(seen)
    return agreed(runs)


def p10_cifar(rank, world, dev, args):
    """The joint sampler under ``score_mode="vmap"`` on make_mesh(model =
    min(2, W)) (each model rank runs its own denoiser, the scores
    all-gathered; the batch split over data) against ``"unroll"`` on this
    rank alone, on the same noise. A model axis of 1 keeps the captured
    loop (at W = 1: step 0, the capture, 19 replays); a model axis above 1
    runs eagerly (an all-gather in the step). ``fused_sde_step`` once a
    step on each rank: the wrapper's count over the 20 steps, and the
    kernels the profiler sees over a new generator's first call of 5 steps
    (the median of three recorded runs)."""
    import torch

    from superdiff_tpu_torch.parallel import mesh as M
    from superdiff_tpu_torch.pipelines import cifar

    cfg = cifar.CONFIGS["vpsdeA"]()
    walls, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t_part, 1)
        t_part = time.perf_counter()

    models = [draw_nonzero_(m, args.seed + k) for k, m in
              enumerate(cifar.build_cifar_models([args.seed, args.seed + 1], cfg, dev))]
    b, steps = cfg.eval_batch_size, P10_CIFAR_STEPS
    labels = torch.arange(10, device=dev).repeat(b // 10 + 1)[:b]
    mesh = M.make_mesh(model=min(2, world))
    captured = mesh.shape["model"] == 1
    g = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (b, cfg.image_size, cfg.image_size, cfg.num_channels)
    noise = (torch.randn(shape, generator=g, device=dev),
             torch.randn((steps,) + shape, generator=g, device=dev))
    make = lambda: cifar.make_generator(models, cfg, n_steps=steps, labels=labels,  # noqa: E731
                                        score_mode="vmap", mesh=mesh)
    part("models")
    gen = make()
    float(gen(noise=noise)[0].sum())  # warm-up (a captured first call builds its graph)
    part("vmap warm-up")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0, logq = gen(noise=noise)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    calls = p10_expect(f"rank {rank}: 10b", read_counts(),
                       fused_sde_step=0 if captured else steps)
    ref = cifar.make_generator(models, cfg, n_steps=steps, labels=labels)
    float(ref(noise=noise)[0].sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rx0, rlogq = ref(noise=noise)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3 / steps
    part("vmap run, unroll warm-up and run")
    x_err = ((x0 - rx0).abs().max() / rx0.abs().max()).item()
    q_err = ((logq - rlogq).abs().max() / rlogq.abs().max().clamp_min(1e-30)).item()
    if not (torch.isfinite(x0).all() and x_err <= P10_CIFAR_TOL and q_err <= P10_CIFAR_TOL):
        raise AssertionError(f"rank {rank}: vmap vs unroll: x0 {x_err}, logq {q_err} "
                             f"(tol {P10_CIFAR_TOL})")
    # a user's first call: captured (step 0, the capture, the replays) or
    # eager, over fewer steps
    short = P10_PROFILE_STEPS
    seen = p10_profiled(lambda: cifar.make_generator(
        models, cfg, n_steps=short, labels=labels, score_mode="vmap", mesh=mesh)(
            noise=(noise[0], noise[1][:short])))
    part("profiled runs")
    dev_launches = seen.get("fused_sde_step", 0)
    if dev_launches != short:
        raise AssertionError(f"rank {rank}: fused_sde_step on the device {dev_launches}, "
                             f"want {short} (1 a step)")
    return {"mesh": dict(mesh.shape), "loop": "captured" if captured else "eager",
            "wrapper calls": calls or "none (replayed graph)",
            "fused_sde_step on the device": f"{dev_launches} / {short} steps",
            "vmap mesh ms/step": round(ms, 3), "unroll one-rank ms/step": round(ref_ms, 3),
            "x0 err": f"{x_err:.2e}", "logq err": f"{q_err:.2e}", "s": walls}


# vmap against unroll: bf16 convolutions of the stacked and the plain
# weights take other cuDNN algorithms; 20 steps carry the rounding
P10_CIFAR_TOL = 5e-2


def p10_sd(rank, world, dev, args):
    """SD ``or`` with the latent batch split over ``data`` (W ranks, 8 / W
    latents each, the default kernels, eager so every launch counts): per
    step on each rank ``sd_or_step`` 1, ``flash_mha_eod`` 10,
    ``geglu_ffn_block`` 16; the gathered latents against the one-process
    run of all 8 on this rank (bit-identical at W = 1; else within 1e-1 of
    the largest latent: two steps magnify a bf16 ulp to ~5 %, phase 3e)."""
    import torch

    from superdiff_tpu_torch.parallel import mesh as M
    from superdiff_tpu_torch.pipelines import sd

    mesh = M.make_mesh(model=1)
    rows = lambda a, dim=0: M.shard_batch(a.movedim(dim, 0), mesh).movedim(0, dim)  # noqa: E731
    mod = sd.build_sd_modules(args.seed, device=dev, dtype=torch.bfloat16)
    cfg = sd.SDPipelineConfig(num_inference_steps=P10_SD_STEPS, height=P10_SD_HW,
                              width=P10_SD_HW)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    lat = (8, P10_SD_HW // 8, P10_SD_HW // 8, 4)
    x0 = torch.randn(lat, generator=g, device=dev)
    zs = torch.randn((P10_SD_STEPS,) + lat, generator=g, device=dev)
    run = lambda noise, b: sd.generate(mod, "or", *PROMPTS, seed=args.seed,  # noqa: E731
                                       batch_size=b, cfg=cfg, noise=noise, decode=False,
                                       capture=False)
    b = 8 // mesh.shape["data"]
    run((rows(x0), rows(zs, 1)), b)  # warm-up
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run((rows(x0), rows(zs, 1)), b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / P10_SD_STEPS
    s = P10_SD_STEPS
    calls = p10_expect(f"rank {rank}: 10c", read_counts(), sd_or_step=s, flash_mha_eod=10 * s,
                       geglu_ffn_block=16 * s)
    lat = mesh.all_gather(out["latents"], "data")
    ref = run((x0, zs), 8)["latents"]
    err = ((lat - ref).abs().max() / ref.abs().max()).item()
    if not torch.isfinite(lat).all() or (world == 1 and err) or err > 1e-1:
        raise AssertionError(f"rank {rank}: DP latents vs one process {err}")
    return {"latents per rank": b, "launches": calls, "ms/step": round(ms, 3),
            "latents vs one process": f"{err:.2e}"}


class CollectiveCount:
    """Counts ``torch.distributed``'s collective calls while in use."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "all_gather", "broadcast",
             "reduce_scatter_tensor", "all_to_all", "batch_isend_irecv", "send", "recv")

    def __enter__(self):
        import torch.distributed as dist

        self.counts = dict.fromkeys(self.NAMES, 0)
        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for n in self.NAMES:
            def wrapped(*a, _n=n, **k):
                self.counts[_n] += 1
                return self.saved[_n](*a, **k)
            setattr(dist, n, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, f in self.saved.items():
            setattr(dist, n, f)


def p10_tp(rank, world, dev, args):
    """The SD-1.x UNet at published widths on the einsum lowering, fp32
    (TF32 off), latent batch 2 at 512 px, 77-token contexts: the forward
    split over tp = W (``place_tp``) against the replicated forward, within
    1e-4 of the output's largest magnitude (the row-parallel partial sums
    in another order). One forward: 64 all-reduces and 16 all-gathers (4
    and 1 per spatial transformer), no other collective, no kernel launch."""
    import copy

    import torch

    from superdiff_tpu_torch.models.sd.unet import SDUNet
    from superdiff_tpu_torch.parallel import tp as T

    ucfg = p10_unet_config()
    with torch.device(dev):
        unet = SDUNet(ucfg, dtype=torch.float32)
    draw_nonzero_(unet, args.seed).eval()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((2, P10_SD_HW // 8, P10_SD_HW // 8, 4), generator=g, device=dev)
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=g, device=dev)
    t = torch.tensor(500.0, device=dev)
    with torch.no_grad():
        ref = unet(x, t, ctx)
        rep_ms = time_ms(lambda: unet(x, t, ctx), budget_ms=300.0, most=5)
        tp = T.place_tp(copy.deepcopy(unet), T.make_tp_mesh(1, world))
        del unet
        zero_counts()
        with CollectiveCount() as cc:
            out = tp(x, t, ctx)
        calls = p10_expect(f"rank {rank}: 10d", read_counts())
        tp_ms = time_ms(lambda: tp(x, t, ctx), budget_ms=300.0, most=5)
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    counts = {k: v for k, v in cc.counts.items() if v}
    if counts != {"all_reduce": 64, "all_gather_into_tensor": 16} or err > 1e-4:
        raise AssertionError(f"rank {rank}: TP forward: collectives {counts}, err {err}")
    return {"collectives": counts, "kernel launches": calls or 0, "err": f"{err:.2e}",
            "TP forward ms": round(tp_ms, 3), "replicated forward ms": round(rep_ms, 3)}


def p10_ring(rank, world, dev, args):
    """``ring_attention`` over ("sp", W) at (B, L, H, D) = (24, 4096, 8,
    40) against plain attention on this rank (fp32 einsums, TF32 off),
    within 1e-5 absolute in fp32 (JAX's test's tolerance) and 3e-2 in bf16;
    W - 1 rotations, one all-gather; no kernel launch."""
    import torch

    from superdiff_tpu_torch.parallel import mesh as M
    from superdiff_tpu_torch.parallel.sp import ring_attention

    mesh = M.Mesh((("sp", world),))
    g = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = (torch.randn(P10_RING_SHAPE, generator=g, device=dev) for _ in range(3))
    scale = P10_RING_SHAPE[-1] ** -0.5

    def plain(a, b, c):
        out = []
        for i in range(0, a.shape[0], 4):
            s = torch.einsum("bqhd,bkhd->bhqk", a[i:i + 4].float(), b[i:i + 4].float())
            out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s * scale, -1),
                                    c[i:i + 4].float()))
        return torch.cat(out)

    figures = {}
    zero_counts()
    for name, dt, tol in (("fp32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 3e-2)):
        a, b, c = (t.to(dt) for t in (q, k, v))
        with CollectiveCount() as cc:
            out = ring_attention(a, b, c, mesh)
        ref = plain(a, b, c)
        err = (out.float() - ref).abs().max().item()
        ring_ms = time_ms(lambda: ring_attention(a, b, c, mesh), budget_ms=200.0, most=5)
        if out.dtype != dt or err > tol or cc.counts["batch_isend_irecv"] != world - 1:
            raise AssertionError(f"rank {rank}: ring {name}: err {err} (tol {tol}), "
                                 f"{cc.counts}")
        figures[name] = f"err {err:.2e} (tol {tol:g}), {ring_ms:.3f} ms"
    figures["kernel launches"] = p10_expect(f"rank {rank}: 10e", read_counts()) or 0
    return figures


def p10_pipeline(rank, world, dev, args):
    """W ``TorchTransformerLayer(256, 4)`` stages (``FrameDiffConfig()``'s
    seq transformer: node 256, 4 heads), one a rank, batch 16 x length 128,
    8 microbatches: the pipelined output and the gradients of sum(out^2)
    (the input's, and this rank's layer's) against the sequential stack on
    this rank, fp32 (TF32 off), within 1e-4 of their largest magnitudes
    (microbatches of 2 against 16 rows: cuBLAS sums in other orders)."""
    import torch

    from superdiff_tpu_torch.models.protein.framediff import FrameDiffConfig
    from superdiff_tpu_torch.models.protein.framediff import TorchTransformerLayer
    from superdiff_tpu_torch.parallel import mesh as M
    from superdiff_tpu_torch.parallel.pp import pipeline

    fcfg = FrameDiffConfig()
    d, heads = fcfg.node_embed_size, fcfg.seq_tfmr_num_heads
    torch.manual_seed(args.seed)
    with torch.device(dev):
        layers = [TorchTransformerLayer(d, heads) for _ in range(world)]
        seq_layers = [TorchTransformerLayer(d, heads) for _ in range(world)]
    for a, b in zip(layers, seq_layers):
        b.load_state_dict(a.state_dict())
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(P10_PP_SHAPE + (d,), generator=g, device=dev)
    mask = lambda xx: torch.ones(xx.shape[:2], device=dev)  # noqa: E731
    stage = lambda layer, xx: layer(xx, mask(xx))  # noqa: E731
    mesh = M.Mesh((("pp", world),))
    zero_counts()
    for _ in range(2):  # the first call sets up NCCL's point-to-point channels
        for layer in layers:
            layer.zero_grad(set_to_none=True)
        xp = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline(stage, layers, xp, mesh, n_micro=8)
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        pp_ms = (time.perf_counter() - t0) * 1e3
    xs = x.clone().requires_grad_(True)
    y = xs
    for layer in seq_layers:
        y = layer(y, mask(y))
    (y ** 2).sum().backward()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = {"out": rel(out.detach(), y.detach()), "x grad": rel(xp.grad, xs.grad)}
    mine, ref = layers[rank], seq_layers[rank]
    errs["layer grads"] = max(rel(p.grad, q.grad) for p, q in
                              zip(mine.parameters(), ref.parameters()))
    calls = p10_expect(f"rank {rank}: 10f", read_counts())
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"rank {rank}: pipeline vs sequential {errs}")
    return {"errs": {k: f"{v:.2e}" for k, v in errs.items()}, "kernel launches": calls or 0,
            "forward + backward ms (second call)": round(pp_ms, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cifar-steps", type=int, default=50)
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--phase6-only", action="store_true",
                    help="run phase 6 alone (main() starts it so, in a fresh process)")
    ap.add_argument("--phase7-only", action="store_true",
                    help="run phase 7 alone (main() starts it so, in a fresh process)")
    ap.add_argument("--phase8-only", action="store_true",
                    help="run phase 8 alone (main() starts it so, in a fresh process)")
    ap.add_argument("--phase9-only", action="store_true",
                    help="run phase 9 alone (main() starts it so, in a fresh process)")
    ap.add_argument("--phase10-only", action="store_true",
                    help="run phase 10 alone, one process per visible card (main() starts "
                    "it so, in a fresh process)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from superdiff_tpu_torch.ops import _build
        from superdiff_tpu_torch.pipelines import sd
    except ImportError as e:
        print(f"chip_smoke: superdiff_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    OUT.mkdir(exist_ok=True)  # every phase, also one run alone, writes its tables there
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.phase6_only:
        train_eval_phase(dev, args)
        return 0
    if args.phase7_only:
        protein_phase(dev, args)
        return 0
    if args.phase8_only:
        struct2seq_training_phase(dev, args)
        return 0
    if args.phase9_only:
        phase9(dev, args)
        return 0
    if args.phase10_only:
        phase10(args)
        return 0
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    log_phase("phase 1: build")
    t0 = time.perf_counter()
    outputs = _build.build_all()
    log(f"  nvcc builds: {time.perf_counter() - t0:.2f} s ({', '.join(outputs)})")
    (OUT / "chip_smoke_build.txt").write_text(
        "".join(f"== {n}\n{o}\n" for n, o in outputs.items()))
    for n, o in outputs.items():
        for line in o.splitlines():
            if "Used" in line or "spill" in line and " 0 bytes spill" not in line:
                log(f"  {n}: {line.strip()}")
    facts = sass_facts()
    if facts is None:
        log("  SASS: no cuobjdump found; wgmma / TMA use not shown")
    else:
        log("  SASS: " + "; ".join(f"{n} " + " ".join(f"{op} {c}" for op, c in f.items())
                                   for n, f in facts.items()))
        for n, f in facts.items():
            if not (f["HGMMA"] and f["UTMALDG"]):
                raise AssertionError(f"{n}: no wgmma / TMA instructions in the built library")
        if facts["geglu_ffn"]["HMMA"] or not facts["geglu_ffn"]["UTMASTG"]:
            raise AssertionError(f"geglu_ffn: mma.sync or no TMA store in the built library "
                                 f"({facts['geglu_ffn']})")
    log(f"  card: {card}")

    log_phase("phase 2: kernels vs their plain versions")
    checks = {"sd_or_step": check_sd_or_step(dev), "flash_mha_eod": check_flash(dev)}
    checks.update(check_geglu(dev))
    checks["fused_sde_step"] = check_fused_sde_step(dev)
    checks.update(check_bhld(dev))
    checks.update(check_packed(dev))
    torch.cuda.empty_cache()

    log_phase(f"phase 3: main path (SD-1.x, or, 512 px, latent batch 8, {args.steps} steps)")
    t0 = time.perf_counter()
    mod = sd.build_sd_modules(args.seed, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  build_sd_modules (random bf16 weights): {time.perf_counter() - t0:.2f} s")
    cfg = sd.SDPipelineConfig(num_inference_steps=args.steps)
    one = sd.SDPipelineConfig(num_inference_steps=1)
    for _ in range(2):  # two synced warmups
        w = eager_generate(sd, mod, "or", *PROMPTS, seed=args.seed, batch_size=8, cfg=one,
                           decode=False)
        float(w["latents"].sum())
    # the main path: captured, the default on the card; the wrappers count
    # the eager step 0 and the capture (a replay counts nothing; phase 5
    # reads the launches on the device from the profiler)
    out, counts, wall = counted_generate(sd, mod, "or", cfg, 8, args.seed, decode=True,
                                         capture=None)
    log(f"  generate (captured): {wall:.3f} s wall")
    expect_counts(f"512 px or, {args.steps} steps captured (step 0 + capture)", counts,
                  sd_or_step=2, flash_mha_eod=20, geglu_ffn_block=32)
    main_counts = counts
    eager, eager_counts, _ = counted_generate(sd, mod, "or", cfg, 8, args.seed)
    expect_counts(f"512 px or, {args.steps} steps eager", eager_counts, sd_or_step=args.steps,
                  flash_mha_eod=10 * args.steps, geglu_ffn_block=16 * args.steps)
    same_run(f"512 px or, {args.steps} steps", out, eager)
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
    del out, eager, lat, img
    torch.cuda.empty_cache()
    sampler, ctxs = sd_captured_and_eager(sd, mod, cfg, 8, args.seed, dev,
                                          f"sampler ({args.steps} steps)")
    torch.cuda.empty_cache()
    generate_in_turns(sd, mod, args.seed, 10)
    torch.cuda.empty_cache()

    log_phase("phase 3b: SD-1.x, or, 768 px, latent batch 8, 2 steps")
    sd_768_phase(sd, mod, args, dev)

    log_phase("phase 3c: SD-1.x, or, 512 px under attn_impl flash_eo / flash and every _LONG_IMPL")
    launches = sd_attn_impl_phase(sd, mod, args, dev)

    log_phase("phase 3d: the other methods at 512 px")
    sd_methods_phase(sd, mod, args, dev)
    torch.cuda.empty_cache()

    log_phase("phase 3e: the packed-layout paths (flash_nat, _CROSS_IMPL xpk / nat)")
    launches.update(sd_packed_phase(sd, mod, args, dev))

    log_phase(f"phase 4: CIFAR joint sampler (vpsdeA, 2 models, batch 100, sde/or, "
        f"{args.cifar_steps} steps)")
    zero_counts()
    models, cifar_cfg, labels = cifar_phase(dev, args)
    others = {k: v for k, v in read_counts().items() if v and k != "fused_sde_step"}
    if others:
        raise AssertionError(f"the CIFAR path launched SD kernels: {others}")

    log_phase("phase 5: launches on the device, profiles and CPU references")
    geglu_launches_only(dev)
    step_kernels_launch_once(dev)
    # the main path's launches: generate as a user's first call runs it
    main_run = lambda: (setattr(mod, "or_loop", None), sd.generate(
        mod, "or", *PROMPTS, seed=args.seed, batch_size=8, cfg=cfg))
    launches.update(counted_runs(f"512 px or, generate, {args.steps} steps", main_run,
                                 args.steps, sd_or_step=1, flash_mha_eod=10,
                                 geglu_ffn_block=16))
    cfg768 = sd.SDPipelineConfig(num_inference_steps=2, height=768, width=768)
    run768 = lambda: (setattr(mod, "or_loop", None), sd.generate(
        mod, "or", *PROMPTS, seed=args.seed, batch_size=8, cfg=cfg768, decode=False))
    got = counted_runs("768 px or, generate, 2 steps", run768, 2, sd_or_step=1,
                       flash_mha_eod=5, _kernel_mh=5, geglu_ffn_block=16, _kernel=5)
    launches.update({k: got[k] for k in ("_kernel", "_kernel_mh")})
    torch.cuda.empty_cache()
    profile_step(sampler, ctxs, dev, args.steps)
    sd_step_profile(sd, mod, args, dev, 768, sd_or_step=1, flash_mha_eod=5, _kernel_mh=5,
                    geglu_ffn_block=16, _kernel=5)
    sd_step_profile(sd, mod, args, dev, 1024, sd_or_step=1, flash_mha_eod=10,
                    geglu_ffn_block=16, _kernel=5)
    torch.cuda.empty_cache()
    unet_reference_check(mod, dev)
    vae_encoder_reference_check(dev, args.seed)
    del mod, sampler, ctxs
    torch.cuda.empty_cache()
    launches.update(cifar_counted_run(models, cifar_cfg, labels, dev))
    cifar_profile(models, cifar_cfg, labels, dev)
    score_unet_reference_check(models[0], cifar_cfg, dev)
    del models
    torch.cuda.empty_cache()

    log_phase(f"phase 6: CIFAR training and FID evaluation (vpsde_less_5 / vpsde_more_5, "
        f"{args.train_steps} steps each; in a fresh process, which no profiler run of "
        f"phase 5 slows)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase6-only",
                           "--seed", str(args.seed), "--train-steps", str(args.train_steps)],
                          timeout=900)
    log(f"  phase 6: {time.perf_counter() - t0:.1f} s, exit code {proc.returncode}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 6 failed (exit code {proc.returncode})")

    log_phase("phase 7: SE(3) protein composition (Proteus + FrameDiff at the checkpoints' widths; "
        "in a fresh process, which no profiler run of phase 5 slows)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase7-only",
                           "--seed", str(args.seed)], timeout=600)
    log(f"  phase 7: {time.perf_counter() - t0:.1f} s, exit code {proc.returncode}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 7 failed (exit code {proc.returncode})")

    log_phase("phase 8: struct2seq-conditioned composition, SE(3) training, the cifar and sd "
              "commands (in a fresh process)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase8-only",
                           "--seed", str(args.seed)], timeout=600)
    log(f"  phase 8: {time.perf_counter() - t0:.1f} s, exit code {proc.returncode}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 8 failed (exit code {proc.returncode})")

    log_phase("phase 9: the SD likelihood, FLD, the 2-D walkthrough and the utilities "
              "(in a fresh process)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase9-only",
                           "--seed", str(args.seed)], timeout=400)
    log(f"  phase 9: {time.perf_counter() - t0:.1f} s, exit code {proc.returncode}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 9 failed (exit code {proc.returncode})")

    log_phase("phase 10: the parallel tier (DP training, the ensemble-sharded CIFAR sampler, "
              "SD over data, TP, ring attention, the pipeline; one process per card)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase10-only",
                           "--seed", str(args.seed)], timeout=300)
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s, exit code {proc.returncode}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 10 failed (exit code {proc.returncode})")

    # the FFN kernel's tanh and unfused configurations: their own counts
    # over the main path's run (phase 3); no served path runs them
    launches.update({name: main_counts[name] for name, *_ in GEGLU_CONFIGS[1:]})
    log(card)
    print(json.dumps({"kernels": [c.row(launches[n]) for n, c in checks.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
