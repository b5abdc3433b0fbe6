"""The ported SD ``or`` slice as a whole vs the JAX pipeline, fp32 on the CPU.

The golden config of ``tests/test_golden_trajectories.py`` (tiny UNet / CLIP
/ VAE, einsum attention and FFN, repeat upsampler, 64 px, 3 steps, batch 2,
seed 7, no dedup), with both packages in fp32 and the same weights: the
JAX parameter trees are carried into the port, and the port is handed the
JAX sampler's threefry draws (regenerated from the same keys).

Tolerance: kappa to 1e-4 absolute (the golden tolerance); latents and
log-likelihoods to 1e-5 of the trajectory's largest magnitude. Each step
multiplies the UNet's fp32 reassociation noise (~1e-6 relative) by
2 |dsigma| g (about 100 at the first step), so elementwise 1e-4 only holds
for a graph compared with itself; across frameworks, and between the
port's dedup and tiled forwards, the latents (|x| up to ~140) differ by
~5e-4 in absolute terms.

``tests/golden/sd.npz`` itself is a bf16 trajectory whose XLA rounding the
port cannot reproduce (see ROADMAP.md, queue C), so the JAX trajectory is
recomputed here in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, draw_params

from superdiff_tpu.models.sd import clip as jclip
from superdiff_tpu.models.sd import unet as junet
from superdiff_tpu.models.sd import vae as jvae
from superdiff_tpu.pipelines import sd as jsd
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig
from superdiff_tpu_torch.models.sd.unet import SDUNetConfig
from superdiff_tpu_torch.models.sd.vae import VAEConfig
from superdiff_tpu_torch.pipelines import sd

torch.set_num_threads(1)

STEPS, HW, BATCH, SEED = 3, 64, 2, 7
KAPPA_ATOL = 1e-4
SCALED_ATOL = 1e-5


@pytest.fixture(scope="module")
def stacks():
    f32 = jnp.float32
    ucfg = dataclasses.replace(junet.SDUNetConfig.tiny(), attn_impl="einsum",
                               ffn_impl="einsum", upsample_impl="repeat")
    tcfg, vcfg = jclip.CLIPTextConfig.tiny(), jvae.VAEConfig.tiny()
    unet = junet.SDUNet(ucfg, dtype=f32)
    text = jclip.CLIPTextEncoder(tcfg, dtype=f32)
    vae = jvae.VAEDecoder(vcfg, dtype=f32)
    up = draw_params(unet, jnp.zeros((1, 16, 16, 4)), jnp.zeros(()),
                     jnp.zeros((1, 77, 64)), seed=1)
    tp = draw_params(text, jnp.zeros((1, 77), jnp.int32), seed=2)
    vp = draw_params(vae, jnp.zeros((1, 8, 8, 4)), seed=3)
    jmod = jsd.SDModules(unet=unet, unet_params=up, text=text, text_params=tp,
                         tokenizer=jclip.Tokenizer(tcfg), vae=vae, vae_params=vp,
                         vae_scaling=vcfg.scaling_factor)
    mod = sd.build_sd_modules(
        0, unet_config=dataclasses.replace(SDUNetConfig.tiny(), upsample_impl="repeat"),
        text_config=CLIPTextConfig.tiny(), vae_config=VAEConfig.tiny(),
        device="cpu", dtype=torch.float32)
    for m, p in ((mod.unet, up), (mod.text, tp), (mod.vae, vp)):
        carry(m, p)
    return jmod, mod


def _close(got, ref, err_msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=SCALED_ATOL,
                               err_msg=err_msg)


def _jax_noise():
    """The JAX sampler's draws for PRNGKey(SEED) (pipelines/sd.py:176-204)."""
    shape = (BATCH, HW // 8, HW // 8, 4)
    init_key, path_key = jax.random.split(jax.random.PRNGKey(SEED))
    x0 = np.asarray(jax.random.normal(init_key, shape))
    zs = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(path_key, i), shape))
                   for i in range(STEPS)])
    return x0, zs


def _cfg(dedup):
    return sd.SDPipelineConfig(num_inference_steps=STEPS, height=HW, width=HW,
                               cond_dedup=dedup)


def test_or_slice_matches_jax_trajectory(stacks):
    jmod, mod = stacks
    jcfg = jsd.SDPipelineConfig(num_inference_steps=STEPS, height=HW, width=HW,
                                cond_dedup=False)
    ref = jsd.generate(jmod, "or", "a cat", "a dog", seed=SEED, batch_size=BATCH,
                       cfg=jcfg, decode=False)
    got = sd.generate(mod, "or", "a cat", "a dog", seed=SEED, batch_size=BATCH,
                      cfg=_cfg(False), noise=_jax_noise(), decode=False)
    _close(got["latents"], ref["latents"])
    for key in ("ll_obj", "ll_bg"):
        _close(got["traces"][key], ref["traces"][key], err_msg=key)
    np.testing.assert_allclose(got["traces"]["kappa"].numpy(),
                               np.asarray(ref["traces"]["kappa"]), rtol=0, atol=KAPPA_ATOL)


def test_dedup_matches_tiled(stacks):
    _, mod = stacks
    noise = _jax_noise()
    on, off = (sd.generate(mod, "or", "a cat", "a dog", seed=SEED, batch_size=BATCH,
                           cfg=_cfg(d), noise=noise, decode=True) for d in (True, False))
    _close(on["latents"], off["latents"])
    np.testing.assert_allclose(on["traces"]["kappa"].numpy(),
                               off["traces"]["kappa"].numpy(), rtol=0, atol=KAPPA_ATOL)
    k = on["traces"]["kappa"].numpy()
    assert k.shape == (STEPS, BATCH) and np.all((k >= 0) & (k <= 1))
    assert on["images"].dtype == torch.uint8 and on["images"].shape == (BATCH, 16, 16, 3)


def test_generator_noise_is_seeded(stacks):
    _, mod = stacks
    one = dataclasses.replace(_cfg(True), num_inference_steps=1)
    a, b = (sd.generate(mod, "or", "a cat", "a dog", seed=3, batch_size=1, cfg=one,
                        decode=False)["latents"] for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("method", ["and", "and_ode", "sd_ab"])
def test_unported_methods_raise(stacks, method):
    _, mod = stacks
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sd.generate(mod, method, "a cat", "a dog", batch_size=1, cfg=_cfg(True))

