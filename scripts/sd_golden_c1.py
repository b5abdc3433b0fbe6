#!/usr/bin/env python3
"""Measure how far the port's SD ``or`` trajectory lies from the bf16 golden
``tests/golden/sd.npz`` (the fault logged as C1 in ROADMAP.md), on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/sd_golden_c1.py

Builds the golden's JAX stack as ``tests/test_golden_trajectories.py::
sd_trajectories`` does (tiny UNet / CLIP / VAE from ``PRNGKey(0)``, einsum
attention and FFN, repeat upsampler, 64 px, 3 steps, batch 2, seed 7, no
conditioning dedup), carries its parameters into the port, and runs the
port's ``generate("or", "a cat", "a dog")`` on the JAX sampler's own
threefry draws: in bf16 and fp32, with ``ffn_impl="einsum"`` (the golden's
lowering) and ``"fused"`` (the fused block's plain version here). Beside
them, the JAX trajectory recomputed in bf16 and in fp32. Prints one line
per run with the max abs error of the final latents and of kappa against
the golden, and a JSON line with all of them. Imports both packages (a
parity measurement, like the tests); needs no card.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from superdiff_tpu.models.sd.clip import CLIPTextConfig as JaxCLIPConfig  # noqa: E402
from superdiff_tpu.models.sd.unet import SDUNetConfig as JaxUNetConfig  # noqa: E402
from superdiff_tpu.models.sd.vae import VAEConfig as JaxVAEConfig  # noqa: E402
from superdiff_tpu.pipelines import sd as jsd  # noqa: E402
from superdiff_tpu_torch.models.from_jax import state_dict_from_flax  # noqa: E402
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig  # noqa: E402
from superdiff_tpu_torch.models.sd.unet import SDUNetConfig  # noqa: E402
from superdiff_tpu_torch.models.sd.vae import VAEConfig  # noqa: E402
from superdiff_tpu_torch.pipelines import sd  # noqa: E402

STEPS, HW, BATCH, SEED = 3, 64, 2, 7


def jax_stack(dtype):
    ucfg = dataclasses.replace(JaxUNetConfig.tiny(), attn_impl="einsum", ffn_impl="einsum",
                               upsample_impl="repeat")
    return jsd.build_sd_modules(jax.random.PRNGKey(0), unet_config=ucfg,
                                text_config=JaxCLIPConfig.tiny(),
                                vae_config=JaxVAEConfig.tiny(), height=HW, width=HW,
                                dtype=dtype)


def jax_noise():
    """The JAX sampler's draws for PRNGKey(SEED): x0 and the per-step normals."""
    shape = (BATCH, HW // 8, HW // 8, 4)
    init_key, path_key = jax.random.split(jax.random.PRNGKey(SEED))
    x0 = np.asarray(jax.random.normal(init_key, shape))
    zs = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(path_key, i), shape))
                   for i in range(STEPS)])
    return x0, zs


def port_run(jmod, ffn_impl, dtype):
    ucfg = dataclasses.replace(SDUNetConfig.tiny(), attn_impl="einsum", ffn_impl=ffn_impl,
                               upsample_impl="repeat")
    mod = sd.build_sd_modules(0, unet_config=ucfg, text_config=CLIPTextConfig.tiny(),
                              vae_config=VAEConfig.tiny(), device="cpu", dtype=dtype)
    for m, p in ((mod.unet, jmod.unet_params), (mod.text, jmod.text_params),
                 (mod.vae, jmod.vae_params)):
        m.load_state_dict(state_dict_from_flax(jax.device_get(p)), strict=True)
    cfg = sd.SDPipelineConfig(num_inference_steps=STEPS, height=HW, width=HW,
                              cond_dedup=False)
    out = sd.generate(mod, "or", "a cat", "a dog", seed=SEED, batch_size=BATCH, cfg=cfg,
                      noise=jax_noise(), decode=False)
    return out["latents"].float().numpy(), out["traces"]["kappa"].numpy()


def jax_run(jmod):
    cfg = jsd.SDPipelineConfig(num_inference_steps=STEPS, height=HW, width=HW,
                               cond_dedup=False)
    r = jsd.generate(jmod, "or", "a cat", "a dog", seed=SEED, batch_size=BATCH, cfg=cfg,
                     decode=False)
    return np.asarray(r["latents"], np.float32), np.asarray(r["traces"]["kappa"], np.float32)


def main() -> int:
    torch.set_num_threads(4)
    golden = np.load(ROOT / "tests" / "golden" / "sd.npz")
    g_lat, g_kappa = golden["sd_or_latents"], golden["sd_or_kappa"]
    stacks = {"bf16": jax_stack(jnp.bfloat16), "fp32": jax_stack(jnp.float32)}
    runs = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for ffn in ("einsum", "fused"):
            runs[f"port {name} ffn_impl={ffn}"] = port_run(stacks[name], ffn, dt)
        runs[f"jax {name} (recomputed)"] = jax_run(stacks[name])
    result = {"golden |latents| max": float(np.abs(g_lat).max())}
    print(f"golden sd_or_latents |x| max {result['golden |latents| max']:.4f}", flush=True)
    for key, (lat, kappa) in runs.items():
        e_lat = float(np.abs(lat - g_lat).max())
        e_kappa = float(np.abs(kappa - g_kappa).max())
        result[key] = {"latents": e_lat, "kappa": e_kappa}
        print(f"{key}: max abs error against the golden: latents {e_lat:.4f}, kappa "
              f"{e_kappa:.3e}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
