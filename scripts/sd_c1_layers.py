#!/usr/bin/env python3
"""Pin the bf16 SD golden gap (ROADMAP C1) to one op, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/sd_c1_layers.py

Builds the golden's stack (``scripts/sd_golden_c1.py``: tiny UNet / CLIP /
VAE from ``PRNGKey(0)``, einsum attention and FFN, repeat upsampler, bf16),
carries the UNet into the port, and runs one UNet forward of both on the
same bf16 inputs (batch 6 = three conditionings of the golden's batch 2,
t = 999): JAX jitted with ``capture_intermediates``, the port with forward
hooks. Prints, module by module in the port's call order up to the second
module off, how many outputs lie more than one bf16 ulp (of JAX's value)
apart; then, at the first
module that does, the op inside it: the SiLU ahead of ``time_embed_2`` on
identical inputs (JAX's compiled HLO beside it) and the Dense alone. Then
the same module walk with an XLA-style SiLU put into the port (every
intermediate of the sigmoid rounded to bf16), and again with the resnet
blocks' second GroupNorm also taking its statistics over the unrounded
fp32 sum ``h + temb``, as XLA's fusion of that reduction does (its
normalization applies to the bf16-rounded sum); and the golden's 3-step
trajectory distance under each. Imports both packages (a parity measurement);
needs no card.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import sd_golden_c1 as c1  # noqa: E402
from superdiff_tpu_torch.models.from_jax import state_dict_from_flax  # noqa: E402
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig  # noqa: E402
from superdiff_tpu_torch.models.sd import unet as sd_unet  # noqa: E402
from superdiff_tpu_torch.models.sd.unet import SDUNetConfig  # noqa: E402
from superdiff_tpu_torch.models.sd.vae import VAEConfig  # noqa: E402
from superdiff_tpu_torch.pipelines import sd  # noqa: E402

F = torch.nn.functional
TORCH_SILU = F.silu


def xla_silu(x):
    """SiLU as XLA's CPU lowering computes it in bf16: exp(-x), 1 + e, the
    reciprocal and x * s each rounded to bf16 (see the HLO this prints)."""
    if x.dtype != torch.bfloat16:
        return TORCH_SILU(x)

    def bf(a):
        return a.float().to(torch.bfloat16)

    e = bf(torch.exp(bf(-x.float()).float()))
    s = bf(1.0 / bf(e.float() + 1.0).float())
    return bf(x.float() * s.float())


def group_norm_split(norm, stats_of, x):
    """``norm`` (a GroupNorm32) with its statistics taken over ``stats_of``
    and applied to ``x``."""
    b, c = x.shape[:2]
    xg = stats_of.float().reshape(b, norm.groups, -1)
    mean = xg.mean(-1)
    var = torch.clamp(xg.square().mean(-1) - mean.square(), min=0.0)
    a = torch.rsqrt(var + norm.eps).repeat_interleave(c // norm.groups, 1) * norm.weight.float()
    bb = norm.bias.float() - mean.repeat_interleave(c // norm.groups, 1) * a
    shape = (b, c) + (1,) * (x.ndim - 2)
    return x * a.reshape(shape).to(x.dtype) + bb.reshape(shape).to(x.dtype)


def resnet_fp32_sum(self, x, temb):
    """``ResnetBlock2D.forward`` with norm2's statistics over the fp32 sum."""
    h = self.conv1(F.silu(self.norm1(x)))
    te = self.time_emb_proj(F.silu(temb))
    if te.shape[0] != h.shape[0]:
        te = te.repeat(h.shape[0] // te.shape[0], 1)
    s = h.float() + te.float()[:, :, None, None]
    h = self.conv2(F.silu(group_norm_split(self.norm2, s, s.to(h.dtype))))
    if self.conv_shortcut is not None:
        x = self.conv_shortcut(x)
    return x + h


def ulps(got, ref):
    """|got - ref| in bf16 ulps of ``ref``."""
    spacing = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return np.abs(got - ref) / spacing


def port_unet(jmod):
    ucfg = dataclasses.replace(SDUNetConfig.tiny(), attn_impl="einsum", ffn_impl="einsum",
                               upsample_impl="repeat")
    mod = sd.build_sd_modules(0, unet_config=ucfg, text_config=CLIPTextConfig.tiny(),
                              vae_config=VAEConfig.tiny(), device="cpu", dtype=torch.bfloat16)
    mod.unet.load_state_dict(state_dict_from_flax(jax.device_get(jmod.unet_params)),
                             strict=True)
    return mod.unet


def module_walk(unet, jax_out, x, t, ctx, what):
    """Each port module's output against JAX's captured one; returns the
    name of the first with an output more than one ulp off."""
    order, got = [], {}

    def hook(m, i, o, name):
        order.append(name)
        got[name] = o

    handles = [m.register_forward_hook(lambda m, i, o, n=n: hook(m, i, o, n))
               for n, m in unet.named_modules() if n]
    with torch.no_grad():
        unet(torch.from_numpy(x), torch.tensor(t), torch.from_numpy(ctx).to(torch.bfloat16))
    for h in handles:
        h.remove()
    print(f"-- {what}: module outputs, port vs JAX (bf16 ulps of JAX's value), up to the "
          f"second module more than one ulp off")
    first, shown = None, 0
    for name in order:
        ref = jax_out.get(name.replace(".", "/"))
        out = got[name]
        if ref is None or isinstance(ref, tuple) or not isinstance(out, torch.Tensor):
            continue
        r, g = np.asarray(ref, np.float32), out.float().numpy()
        if g.shape != r.shape and g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        if g.shape != r.shape:
            continue
        over = float((ulps(g, r) > 1).mean())
        print(f"   {name:38s} > 1 ulp: {over:.4f}  max abs {np.abs(g - r).max():.3e}")
        if over > 0:
            shown += 1
            first = first or name
            if shown == 2:
                break
    return first, got


def main() -> int:
    torch.set_num_threads(4)
    jmod = c1.jax_stack(jnp.bfloat16)
    unet = port_unet(jmod)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((6, 77, jmod.unet.config.cross_attention_dim)).astype(np.float32)
    t = np.float32(999.0)
    _, state = jax.jit(lambda p, x, c: jmod.unet.apply(
        {"params": p}, x, t, c, capture_intermediates=True))(jmod.unet_params, x, ctx)
    captured = {}

    def walk(d, prefix):
        for k, v in d.items():
            if k == "__call__":
                captured[prefix] = v[0]
            elif isinstance(v, dict):
                walk(v, f"{prefix}/{k}" if prefix else k)

    walk(jax.device_get(state["intermediates"]), "")
    first, _ = module_walk(unet, captured, x, t, ctx, "as ported")
    print(f"first module more than one ulp off: {first}")

    h1 = jnp.asarray(captured["time_embed_1"])  # bf16, equal in both
    silu_jax = np.asarray(jax.jit(fnn.swish)(h1), np.float32)
    h1t = torch.from_numpy(np.asarray(h1, np.float32)).to(torch.bfloat16)
    silu_port = TORCH_SILU(h1t).float().numpy()
    u = ulps(silu_port, silu_jax)
    print(f"-- op: SiLU of time_embed_1's output ({h1.size} values, identical inputs): "
          f"{(u > 0).mean():.4f} differ, {(u > 1).mean():.4f} by more than one ulp, at most "
          f"{u.max():.0f} ulps; XLA-style SiLU in torch vs JAX: "
          f"{(xla_silu(h1t).float().numpy() != silu_jax).mean():.4f} differ")
    hlo = jax.jit(fnn.swish).lower(h1).compile().as_text()
    print("   JAX's compiled SiLU (bf16 in, bf16 out):")
    for line in hlo.splitlines():
        if any(op in line for op in (" negate(", " exponential(", " add(", " divide(",
                                      " multiply(", " convert(")) and "%" in line:
            print("     " + line.split(", metadata")[0].strip())
    p = jax.device_get(jmod.unet_params)["time_embed_2"]
    dense = fnn.Dense(p["kernel"].shape[1], dtype=jnp.bfloat16)
    d_jax = np.asarray(jax.jit(lambda v: dense.apply({"params": p}, v))(
        jnp.asarray(silu_jax, jnp.bfloat16)), np.float32)
    d_port = F.linear(torch.from_numpy(silu_jax).to(torch.bfloat16),
                      torch.from_numpy(np.asarray(p["kernel"], np.float32).T.copy()).to(
                          torch.bfloat16),
                      torch.from_numpy(np.array(p["bias"], np.float32)).to(torch.bfloat16))
    print(f"-- op: time_embed_2's Dense on identical inputs: "
          f"{(d_port.float().numpy() != d_jax).mean():.4f} of outputs differ")

    golden = np.load(ROOT / "tests" / "golden" / "sd.npz")
    resnet_forward = sd_unet.ResnetBlock2D.forward
    passes = (("PyTorch SiLU", TORCH_SILU, resnet_forward),
              ("XLA-style SiLU", xla_silu, resnet_forward),
              ("XLA-style SiLU, norm2 statistics over the fp32 sum", xla_silu, resnet_fp32_sum))
    try:
        for name, silu, forward in passes:
            F.silu, sd_unet.ResnetBlock2D.forward = silu, forward
            if name != "PyTorch SiLU":
                first, _ = module_walk(unet, captured, x, t, ctx, f"with {name} in the port")
                print(f"first module more than one ulp off: {first}")
            lat, kappa = c1.port_run(jmod, "einsum", torch.bfloat16)
            print(f"-- port bf16, 3 steps, {name}: max abs error against the golden: "
                  f"latents {np.abs(lat - golden['sd_or_latents']).max():.4f}, kappa "
                  f"{np.abs(kappa - golden['sd_or_kappa']).max():.3e}")
    finally:
        F.silu, sd_unet.ResnetBlock2D.forward = TORCH_SILU, resnet_forward
    return 0


if __name__ == "__main__":
    sys.exit(main())
