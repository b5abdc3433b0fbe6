"""Port CLIP text encoder, VAE decoder and encoder, and tokenizer fallback vs
the JAX package, tiny configs, fp32 on the CPU (tolerance 1e-5 relative to
the output's largest magnitude: sums in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, draw_params, t

from superdiff_tpu.models.sd import clip as jclip
from superdiff_tpu.models.sd import vae as jvae
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig, CLIPTextEncoder, Tokenizer
from superdiff_tpu_torch.models.sd.vae import (VAEConfig, VAEDecoder, VAEEncoder,
                                               decode_to_uint8)

torch.set_num_threads(1)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("prompts", [["a cat", ""], ["a photo of a dog on the grass"]])
def test_tokenizer_fallback_ids_match_jax(prompts):
    for cfg in (CLIPTextConfig(), CLIPTextConfig.tiny()):
        jcfg = jclip.CLIPTextConfig(**vars(cfg))
        np.testing.assert_array_equal(Tokenizer(cfg)(prompts), jclip.Tokenizer(jcfg)(prompts))


def test_clip_text_encoder_matches_jax():
    jcfg = jclip.CLIPTextConfig.tiny()
    jmod = jclip.CLIPTextEncoder(jcfg, dtype=jnp.float32)
    params = draw_params(jmod, jnp.zeros((1, 77), jnp.int32), seed=5)
    ids = jclip.Tokenizer(jcfg)(["a cat", "a dog on a mat", ""])
    ref = jmod.apply({"params": params}, jnp.asarray(ids))
    port = carry(CLIPTextEncoder(CLIPTextConfig.tiny(), dtype=torch.float32), params)
    with torch.no_grad():
        got = port(t(ids).long())
    assert got.dtype == torch.float32 and got.shape == (3, 77, 64)
    _close(got.numpy(), ref)


@pytest.fixture(scope="module")
def vaes():
    jdec = jvae.VAEDecoder(jvae.VAEConfig.tiny(), dtype=jnp.float32)
    params = draw_params(jdec, jnp.zeros((1, 8, 8, 4)), seed=6)
    port = carry(VAEDecoder(VAEConfig.tiny(), dtype=torch.float32), params)
    return jdec, params, port


def test_vae_decoder_matches_jax(vaes):
    jdec, params, port = vaes
    z = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = jdec.apply({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        got = port(t(z))
    assert got.shape == (2, 16, 16, 3)
    _close(got.numpy(), ref)


def test_decode_to_uint8_matches_jax(vaes):
    jdec, params, port = vaes
    # small latents keep the images off the clip bounds, so the truncation
    # to uint8 compares values, not saturation
    z = 0.05 * np.random.default_rng(8).standard_normal((1, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jvae.decode_to_uint8(jdec, params, jnp.asarray(z), 0.18215))
    with torch.no_grad():
        got = decode_to_uint8(port, t(z), 0.18215).numpy()
    assert got.dtype == np.uint8
    # a pixel may land on the other side of an integer boundary
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("h,w", [(16, 16), (16, 24)])
def test_vae_encoder_matches_jax(h, w):
    """(mean, logvar) of images; the stride-2 down conv pads (0, 1) on each
    axis, as diffusers' encoder does (a symmetric pad shifts every output)."""
    jenc = jvae.VAEEncoder(jvae.VAEConfig.tiny(), dtype=jnp.float32)
    params = draw_params(jenc, jnp.zeros((1, 16, 16, 3)), seed=9)
    port = carry(VAEEncoder(VAEConfig.tiny(), dtype=torch.float32), params)
    x = np.random.default_rng(10).standard_normal((2, h, w, 3)).astype(np.float32)
    ref = jenc.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(t(x))
    assert got.dtype == torch.float32 and got.shape == (2, h // 2, w // 2, 8)
    _close(got.numpy(), ref)
