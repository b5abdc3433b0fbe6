"""The ported SD pipeline as a whole vs the JAX pipeline, fp32 on the CPU:
``or`` and the SDE methods here, the ODE methods and the ``sd_*`` baselines
in ``test_torch_sd_methods.py`` (same fixtures, imported from here).

The golden config of ``tests/test_golden_trajectories.py`` (tiny UNet / CLIP
/ VAE, einsum attention and FFN, repeat upsampler, 64 px, 3 steps, batch 2,
seed 7, no dedup), with both packages in fp32 and the same weights: the
JAX parameter trees are carried into the port, and the port is handed the
JAX sampler's threefry draws (regenerated from the same keys).

Tolerance (``or``, ``avg``): kappa to 1e-4 absolute (the golden tolerance); latents and
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

from superdiff_tpu.core import ito as jito
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


def _close(got, ref, err_msg="", atol=SCALED_ATOL):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=atol,
                               err_msg=err_msg)


def _jax_noise(seed=SEED, steps=STEPS):
    """The JAX sampler's draws for PRNGKey(seed) (pipelines/sd.py:176-222):
    the initial latent, the per-step normals and the per-step Rademacher
    probes (drawn from the same step key as the normals)."""
    shape = (BATCH, HW // 8, HW // 8, 4)
    init_key, path_key = jax.random.split(jax.random.PRNGKey(seed))
    x0 = np.asarray(jax.random.normal(init_key, shape))
    keys = [jax.random.fold_in(path_key, i) for i in range(steps)]
    zs = np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys])
    probes = np.stack([np.asarray(jito.rademacher(k, shape)) for k in keys])
    return x0, zs, probes


def _cfg(dedup, steps=STEPS):
    return sd.SDPipelineConfig(num_inference_steps=steps, height=HW, width=HW,
                               cond_dedup=dedup)


# The AND kappa divides by sum((v_obj - v_bg)^2): prompts that share most
# tokens make the two velocities nearly equal under random weights, and the
# UNet's fp32 reassociation noise then moves kappa in its third digit in
# either framework. The new methods therefore get prompts that differ in
# every token (the ``or`` test keeps the golden prompts).
PROMPTS = ("a photo of a cat sitting on a sofa",
           "an oil painting of mountains at dusk, trending")


_jax_samplers = {}


def _jax_generate(jmod, method, prompts, seed, steps=STEPS):
    """``jsd.generate`` without decoding, with one jitted sampler per module
    and step count shared by the six ``sd_*`` baselines (they differ only in
    their prompt, which ``prepare_contexts`` builds)."""
    family = (id(jmod), steps, "sd_a" if method.startswith("sd_") else method)
    if family not in _jax_samplers:
        jcfg = jsd.SDPipelineConfig(num_inference_steps=steps, height=HW, width=HW,
                                    cond_dedup=False, lift=0.3, kappa_fixed=0.4)
        _jax_samplers[family] = jsd.make_sampler(jmod, family[2], jcfg)
    ctxs = jsd.prepare_contexts(jmod, method, *prompts, BATCH)
    latents, traces = _jax_samplers[family](jax.random.PRNGKey(seed), *ctxs)
    return {"latents": latents, "traces": traces}


def check_method_matches_jax(stacks, method, prompts=PROMPTS, kappa_atol=KAPPA_ATOL,
                             scaled_atol=SCALED_ATOL, seed=SEED, steps=STEPS):
    """One method's port trajectory against the JAX fp32 trajectory; ``stacks``
    is (JAX modules, port modules)."""
    jmod, mod = stacks
    ref = _jax_generate(jmod, method, prompts, seed, steps)
    cfg = dataclasses.replace(_cfg(False, steps), lift=0.3, kappa_fixed=0.4)
    got = sd.generate(mod, method, *prompts, seed=seed, batch_size=BATCH,
                      cfg=cfg, noise=_jax_noise(seed, steps), decode=False)
    _close(got["latents"], ref["latents"], atol=scaled_atol)
    for key in ("ll_obj", "ll_bg", "final_ll_obj", "final_ll_bg", "final_ll_uncond"):
        _close(got["traces"][key], ref["traces"][key], err_msg=key, atol=scaled_atol)
    np.testing.assert_allclose(got["traces"]["kappa"].numpy(),
                               np.asarray(ref["traces"]["kappa"]), rtol=0, atol=kappa_atol,
                               err_msg="kappa")
    return got, ref


def test_or_slice_matches_jax_trajectory(stacks):
    check_method_matches_jax(stacks, "or", prompts=("a cat", "a dog"))


# ``and``: kappa is a ratio of differences of O(1e3) sums, so the UNet's fp32
# reassociation noise reaches its fourth digit (measured 1.1e-4) and, through
# 2 |dsigma| g kappa (v_obj - v_bg), the latents at 7e-5 of their scale.
@pytest.mark.parametrize("method,kappa_atol,scaled_atol",
                         [("and", 1e-3, 1e-4), ("avg", KAPPA_ATOL, SCALED_ATOL)])
def test_sde_method_matches_jax_trajectory(stacks, method, kappa_atol, scaled_atol):
    got, _ = check_method_matches_jax(stacks, method, kappa_atol=kappa_atol,
                                      scaled_atol=scaled_atol)
    k = got["traces"]["kappa"]
    if method == "avg":
        assert torch.all(k == 0.4)
    assert torch.all(got["traces"]["final_ll_uncond"] == 1.0)


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


def test_unknown_method_raises(stacks):
    _, mod = stacks
    with pytest.raises(ValueError, match="unknown method"):
        sd.generate(mod, "xor", "a cat", "a dog", batch_size=1, cfg=_cfg(True))
