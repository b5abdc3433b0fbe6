"""``ops.group_norm``: the GroupNorm with fp32 statistics, an optional
per-channel input shift and an optional SiLU that ``GroupNorm32`` computes,
on the CPU (the kernel itself runs only on the card: ``chip_smoke.py``
phase 2 holds it to :func:`group_norm_plain` there).

* The plain version against the composition ``GroupNorm32`` ran before it
  took the shift and the SiLU (``h + te`` in x's dtype, the norm applied as
  ``x * a + b`` in x's dtype, then ``F.silu``), frozen below as
  ``_composition``, at C/G of 4, 10, 12, 40 and 80, both layouts, shift and
  SiLU on and off. In fp32 the two run the same fp32 operations in the same
  order and agree bit for bit. In bf16 the composition rounds ``x + shift``,
  ``x * a``, ``+ b`` and the SiLU's output to bf16 where the plain version
  rounds its fp32 result once, so the two are at most a few bf16 roundings
  apart: within 4 x 2^-8 of the largest output.
* ``group_norm``'s autograd Function (its plain forward on CPU tensors):
  the forward equals the plain version bit for bit; the backward (written
  from the saved fp32 mean and rstd) and ``torch.func.jvp`` (the plain
  version's) agree with autograd of the composition in fp32, within 1e-5 of
  the largest gradient (another order of the same fp32 sums).
* The Function against the JAX package's ``GroupNorm32`` with the shift
  added before it and the SiLU after it, as the resnet blocks call it, in
  fp32 at the C/G values the served nets use (4, 10, 12, 40, 80): the
  output, the backward against ``jax.vjp``, ``torch.func.jvp`` against
  ``jax.jvp`` and ``torch.func.vmap`` (over stacked x, weight, bias and
  shift, as the ensemble's vmap maps them) against ``jax.vmap``, each
  within 1e-5 of the largest value it is compared with: the two run the
  same fp32 operations with the group sums in another order (a few ulps of
  sums of at most 2 400 terms).
* ``score_mode="vmap"`` against ``"unroll"`` on two tiny ScoreUNets, every
  GroupNorm32 going through the Function's vmap rule (one call per slice),
  within 1e-5 of the largest score, the tolerance of the stacked oracle's
  own vmap test.
* A (1, C) shift expanded over the batch (a scalar t's one embedding row)
  gives what the full (B, C) shift gives, and its gradient is the sum of
  the full one's rows.
* The operands the kernel does not take raise, on the CPU too.
* The kernels' names fall in no family of the benchmark's frozen taxonomy
  and in the port's own ``group_norm`` family.
* ``GroupNorm32`` counts each norm (``profiling.count("group_norms")``):
  61 in a forward of SD-1.x's UNet and 52 in one of the CIFAR ScoreUNet at
  their published widths, traced on the meta device.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superdiff_tpu.models.unet import GroupNorm32 as JaxGroupNorm32

from superdiff_tpu_torch.models.unet import GroupNorm32, ScoreUNet
from superdiff_tpu_torch.ops import group_norm as gn
from superdiff_tpu_torch.ops.group_norm import group_norm, group_norm_plain
from superdiff_tpu_torch.utils import profiling, traceparse

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GROUPS = 8
EPS = 1e-6


def _composition(x, weight, bias, groups, eps, shift=None, silu=False):
    """``GroupNorm32`` and its callers before the kernel: the shift added in
    x's dtype, the norm applied in x's dtype, then ``F.silu``."""
    if shift is not None:
        x = x + shift[:, :, None, None]
    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, -1)
    mean = xg.mean(-1)
    var = torch.clamp(xg.square().mean(-1) - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    per_ch = c // groups
    a = rstd.repeat_interleave(per_ch, dim=1) * weight.float()
    bb = bias.float() - mean.repeat_interleave(per_ch, dim=1) * a
    shape = (b, c) + (1,) * (x.ndim - 2)
    y = x * a.reshape(shape).to(x.dtype) + bb.reshape(shape).to(x.dtype)
    return F.silu(y) if silu else y


def _operands(cpg, dtype=torch.float32, channels_last=True, shift=False, seed=0,
              shape=(2, None, 5, 6)):
    g = torch.Generator().manual_seed(seed + cpg)
    c = cpg * GROUPS
    b, _, h, w = shape
    x = (1.5 * torch.randn(b, c, h, w, generator=g) + 0.3).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    weight = 1 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    sh = torch.randn(b, c, generator=g).to(dtype) if shift else None
    return x, weight, bias, sh


@pytest.mark.parametrize("cpg", [4, 10, 12, 40, 80])
@pytest.mark.parametrize("silu", [False, True], ids=["nosilu", "silu"])
@pytest.mark.parametrize("shift", [False, True], ids=["noshift", "shift"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_matches_the_composition(dtype, channels_last, shift, silu, cpg):
    x, weight, bias, sh = _operands(cpg, dtype, channels_last, shift)
    got = group_norm_plain(x, weight, bias, GROUPS, EPS, sh, silu)
    ref = _composition(x, weight, bias, GROUPS, EPS, sh, silu)
    assert got.dtype == dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last) == channels_last
    if dtype == torch.float32:
        assert torch.equal(got, ref)
    else:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 4 * 2.0**-8 * ref.float().abs().max().item()


@pytest.mark.parametrize("silu", [False, True], ids=["nosilu", "silu"])
@pytest.mark.parametrize("shift", [False, True], ids=["noshift", "shift"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_function_forward_is_the_plain_version(dtype, channels_last, shift, silu):
    x, weight, bias, sh = _operands(10, dtype, channels_last, shift)
    got = group_norm(x, weight, bias, GROUPS, EPS, shift=sh, silu=silu)
    assert torch.equal(got, group_norm_plain(x, weight, bias, GROUPS, EPS, sh, silu))
    assert got.stride() == x.stride()


def test_a_broadcast_shift_row_is_taken():
    """A scalar t gives the ScoreUNet one embedding row: it reaches the
    norm expanded over the batch (row stride 0), and its gradient sums."""
    x, weight, bias, sh = _operands(10, shift=True)
    row = sh[:1].clone().requires_grad_()
    got = group_norm(x, weight, bias, GROUPS, EPS, shift=row.expand(x.shape[0], -1), silu=True)
    full = row.detach().expand(x.shape[0], -1).contiguous().requires_grad_()
    ref = group_norm(x, weight, bias, GROUPS, EPS, shift=full, silu=True)
    assert torch.equal(got, ref)
    gy = torch.randn(got.shape, generator=torch.Generator().manual_seed(8))
    (g_row,), (g_full,) = torch.autograd.grad(got, row, gy), torch.autograd.grad(ref, full, gy)
    assert torch.allclose(g_row, g_full.sum(0, keepdim=True), rtol=1e-6, atol=1e-6)


def _grad_inputs(shift, channels_last):
    x, weight, bias, sh = _operands(10, torch.float32, channels_last, shift, seed=3)
    return [t.requires_grad_() for t in (x, weight, bias, sh) if t is not None]


def _close(got, ref, rel=1e-5):
    return (got - ref).abs().max().item() <= rel * ref.abs().max().item()


@pytest.mark.parametrize("silu", [False, True], ids=["nosilu", "silu"])
@pytest.mark.parametrize("shift", [False, True], ids=["noshift", "shift"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_backward_matches_the_composition(channels_last, shift, silu):
    ins = _grad_inputs(shift, channels_last)
    sh = ins[3] if shift else None
    got = group_norm(*ins[:3], GROUPS, EPS, shift=sh, silu=silu)
    ref = _composition(*ins[:3], GROUPS, EPS, sh, silu)
    gy = torch.randn(got.shape, generator=torch.Generator().manual_seed(4))
    g_got = torch.autograd.grad(got, ins, gy)
    g_ref = torch.autograd.grad(ref, ins, gy)
    for name, a, b in zip(("x", "weight", "bias", "shift"), g_got, g_ref):
        assert a.shape == b.shape and _close(a, b), name


@pytest.mark.parametrize("silu", [False, True], ids=["nosilu", "silu"])
@pytest.mark.parametrize("shift", [False, True], ids=["noshift", "shift"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_jvp_matches_the_composition(channels_last, shift, silu):
    prim = tuple(t.detach() for t in _grad_inputs(shift, channels_last))
    g = torch.Generator().manual_seed(5)
    tans = tuple(torch.randn(p.shape, generator=g) for p in prim)
    split = lambda a: (a[:3], a[3] if shift else None)
    got = torch.func.jvp(lambda *a: group_norm(*split(a)[0], GROUPS, EPS, shift=split(a)[1],
                                               silu=silu), prim, tans)
    ref = torch.func.jvp(lambda *a: _composition(*split(a)[0], GROUPS, EPS, split(a)[1], silu),
                         prim, tans)
    assert _close(got[0], ref[0]) and _close(got[1], ref[1])


# C/G of the served nets' norms, and how their callers use them: (shift, SiLU)
CPG_IN_USE = [4, 10, 12, 40, 80]
MODES = {"norm": (False, False), "norm_silu": (False, True), "shift_norm_silu": (True, True)}


def _jax_norm(shift, silu):
    """The JAX package's GroupNorm32 on NHWC x, with ``x + shift`` before it
    and SiLU after it when asked (XLA fuses the three in the reference)."""
    mod = JaxGroupNorm32(num_groups=GROUPS, eps=EPS)

    def f(x, w, b, *sh):
        if shift:
            x = x + sh[0][:, None, None, :]
        y = mod.apply({"params": {"GroupNorm_0": {"scale": w, "bias": b}}}, x)
        return jax.nn.silu(y) if silu else y

    return jax.jit(f)


def _nhwc(a):
    """A port operand as the JAX side takes it: x and its cotangents NHWC."""
    a = a.detach()
    return jnp.asarray((a.movedim(-3, -1) if a.ndim >= 4 else a).numpy())


def _from_jax(a, like):
    a = torch.from_numpy(np.array(a))
    return a.movedim(-1, -3) if like.ndim >= 4 else a


def _jax_case(cpg, mode, seed):
    shift, silu = MODES[mode]
    ins = [t for t in _operands(cpg, shift=shift, seed=seed) if t is not None]
    port = lambda *a: group_norm(*a[:3], GROUPS, EPS, shift=a[3] if shift else None,
                                 silu=silu)
    return ins, port, _jax_norm(shift, silu)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("cpg", CPG_IN_USE)
def test_backward_matches_jax(cpg, mode):
    ins, port, ref = _jax_case(cpg, mode, seed=20)
    ins = [t.requires_grad_() for t in ins]
    y = port(*ins)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(21))
    grads = torch.autograd.grad(y, ins, gy)
    y_ref, vjp = jax.vjp(ref, *map(_nhwc, ins))
    assert _close(y.detach(), _from_jax(y_ref, y))
    for name, got, want, like in zip(("x", "weight", "bias", "shift"), grads,
                                     vjp(_nhwc(gy)), ins):
        assert got.shape == like.shape and _close(got, _from_jax(want, like)), name


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("cpg", CPG_IN_USE)
def test_jvp_matches_jax(cpg, mode):
    ins, port, ref = _jax_case(cpg, mode, seed=22)
    g = torch.Generator().manual_seed(23)
    tans = [torch.randn(t.shape, generator=g) for t in ins]
    y, ty = torch.func.jvp(port, tuple(ins), tuple(tans))
    y_ref, ty_ref = jax.jvp(ref, tuple(map(_nhwc, ins)), tuple(map(_nhwc, tans)))
    assert _close(y, _from_jax(y_ref, y)) and _close(ty, _from_jax(ty_ref, ty))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("cpg", CPG_IN_USE)
def test_vmap_matches_jax(cpg, mode):
    stacked = [torch.stack(z) for z in zip(*(_jax_case(cpg, mode, seed=24 + k)[0]
                                             for k in range(2)))]
    _, port, ref = _jax_case(cpg, mode, seed=24)
    got = torch.func.vmap(port)(*stacked)
    want = jax.vmap(ref)(*map(_nhwc, stacked))
    assert got.shape == stacked[0].shape and _close(got, _from_jax(want, got))


def _tiny_score_unets():
    from superdiff_tpu_torch.models.from_jax import init_like_flax_

    models = []
    for i in range(2):
        net = init_like_flax_(ScoreUNet(nf=16, ch_mult=(1, 2), num_res_blocks=1,
                                        attn_resolutions=(8,), image_size=16),
                              torch.Generator().manual_seed(i))
        g = torch.Generator().manual_seed(10 + i)
        with torch.no_grad():  # non-zero output layers and norm parameters
            for name, p in net.named_parameters():
                z = torch.randn(p.shape, generator=g)
                p.copy_(z / p[0].numel() ** 0.5 if p.ndim > 1
                        else (1.0 + 0.1 * z if name.endswith("weight") else 0.1 * z))
        models.append(net.eval())
    return models


def test_score_unet_vmap_matches_unroll(monkeypatch):
    from superdiff_tpu_torch.models.ensemble import make_stacked_score_fn

    models = _tiny_score_unets()
    x = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        ref = make_stacked_score_fn(models, mode="unroll")(0.4, x)
    rule, slices = gn._GroupNorm.vmap, []

    def counting_rule(info, in_dims, *args):
        slices.append(info.batch_size)
        return rule(info, in_dims, *args)

    monkeypatch.setattr(gn._GroupNorm, "vmap", staticmethod(counting_rule))
    with torch.no_grad():
        got = make_stacked_score_fn(models, mode="vmap")(0.4, x)
    n_norms = sum(isinstance(m, GroupNorm32) for m in models[0].modules())
    assert slices == [2] * n_norms
    assert got.shape == ref.shape == (2, 3, 16, 16, 3)
    assert _close(got, ref)


def _bad(**change):
    x, weight, bias, sh = _operands(10, shift=True)
    args = dict(x=x, weight=weight, bias=bias, groups=GROUPS, shift=sh)
    args.update({k: v(args) for k, v in change.items()})
    return args


REJECTED = {
    "3-D x": dict(x=lambda a: a["x"][:, :, 0]),
    "fp16 x": dict(x=lambda a: a["x"].half(), shift=lambda a: None),
    "fp64 x": dict(x=lambda a: a["x"].double(), shift=lambda a: None),
    "C not a multiple of 8": dict(x=lambda a: a["x"][:, :76].contiguous(), groups=lambda a: 4,
                                  weight=lambda a: a["weight"][:76],
                                  bias=lambda a: a["bias"][:76], shift=lambda a: None),
    "groups not dividing C": dict(groups=lambda a: 3),
    "fp32 C over the kernel's most": dict(
        x=lambda a: torch.zeros(1, 4104, 2, 2), groups=lambda a: 8,
        weight=lambda a: torch.ones(4104), bias=lambda a: torch.zeros(4104),
        shift=lambda a: None),
    "bf16 C over the kernel's most": dict(
        x=lambda a: torch.zeros(1, 4104, 2, 2, dtype=torch.bfloat16), groups=lambda a: 8,
        weight=lambda a: torch.ones(4104), bias=lambda a: torch.zeros(4104),
        shift=lambda a: None),
    "strided x": dict(x=lambda a: a["x"][:, :, :, ::2]),
    "permuted x": dict(x=lambda a: a["x"].transpose(2, 3)),
    "weight of another size": dict(weight=lambda a: a["weight"][:40]),
    "bf16 weight and bias": dict(weight=lambda a: a["weight"].bfloat16(),
                                 bias=lambda a: a["bias"].bfloat16()),
    "shift in another dtype than x": dict(shift=lambda a: a["shift"].bfloat16()),
    "shift of another shape": dict(shift=lambda a: a["shift"][:, :40]),
    "strided shift": dict(shift=lambda a: torch.zeros(80, 2).t()),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_group_norm_rejects_what_the_kernel_does_not_take(case):
    a = _bad(**REJECTED[case])
    with pytest.raises(ValueError, match="group_norm"):
        group_norm(a["x"], a["weight"], a["bias"], a["groups"], EPS, shift=a["shift"])


def test_kernel_names_fall_in_no_frozen_family():
    sys.path.insert(0, str(REPO))
    from benchmark.harness import tracing

    src = (REPO / "superdiff_tpu_torch/ops/csrc/group_norm.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", src)
    assert sorted(names) == ["group_norm_apply_cf", "group_norm_apply_cl",
                             "group_norm_stats_cf", "group_norm_stats_cl"]
    for name in names:
        for args in ("__nv_bfloat16", "float", "__nv_bfloat16, 8", "float, 1"):
            full = f"void (anonymous namespace)::{name}<{args}>((anonymous namespace)::GnArgs)"
            assert tracing.family(full) == "other", full
            assert traceparse.family(full) == "group_norm", full


def _count_norms(model, *inputs):
    with profiling.record() as rec, torch.no_grad():
        model(*inputs)
    return rec.totals["group_norms"]


def test_group_norm32_counts_each_norm():
    from superdiff_tpu_torch.models.sd.unet import SDUNet, SDUNetConfig

    with torch.device("meta"):
        sd_unet = SDUNet(SDUNetConfig(attn_impl="einsum", ffn_impl="einsum"))
        score = ScoreUNet()
        sd_norms = _count_norms(sd_unet, torch.empty(2, 64, 64, 4), torch.zeros(()),
                                torch.empty(2, 3, 768))
        score_norms = _count_norms(score, torch.zeros(2, 1, 1, 1), torch.empty(2, 32, 32, 3))
    assert (sd_norms, score_norms) == (61, 52)
    assert sd_norms == sum(isinstance(m, GroupNorm32) for m in sd_unet.modules())
