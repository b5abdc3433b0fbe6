"""Port SD UNet vs the JAX SDUNet at the tiny config, fp32 on the CPU.

32x32 latents give 1024-token self-attention at the first level, so the
port's long-row routing (d-major projections into ``flash_mha_eod``, its
plain version here) and the short-row einsum path are both exercised. The
JAX model runs its pure-XLA lowering (einsum attention and FFN); both sides
use the subpixel upsampler. fp32 tolerance: 1e-5 relative to the output's
largest magnitude (sums are taken in other orders by XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, draw_params, t

from superdiff_tpu.models.sd.unet import SDUNet as JaxSDUNet
from superdiff_tpu.models.sd.unet import SDUNetConfig as JaxSDUNetConfig
from superdiff_tpu_torch.models.sd.unet import (
    SDUNet,
    SDUNetConfig,
    SubpixelUpsample,
    sd_timestep_embedding,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def unets():
    jcfg = dataclasses.replace(JaxSDUNetConfig.tiny(), attn_impl="einsum", ffn_impl="einsum")
    jnet = JaxSDUNet(jcfg, dtype=jnp.float32)
    params = draw_params(jnet, jnp.zeros((1, 16, 16, 4)), jnp.zeros(()),
                         jnp.zeros((1, 77, 64)))
    net = carry(SDUNet(SDUNetConfig.tiny(), dtype=torch.float32), params)
    fwd = jax.jit(lambda p, x, tt, c: jnet.apply({"params": p}, x, tt, c))
    return fwd, params, net


@pytest.mark.parametrize("dedup", [True, False])
def test_unet_matches_jax(unets, dedup):
    fwd, params, net = unets
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1 if dedup else 3, 32, 32, 4)).astype(np.float32)
    ctx = rng.standard_normal((3, 77, 64)).astype(np.float32)
    ref = np.asarray(fwd(params, x, np.float32(481.0), ctx))
    with torch.no_grad():
        got = net(t(x), torch.tensor(481.0), t(ctx)).numpy()
    assert got.shape == ref.shape == (3, 32, 32, 4)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-5)


def test_long_rows_route_through_flash_mha_eod(unets, monkeypatch):
    """Self-attention over > 256 tokens goes through flash_mha_eod (its
    plain version on the CPU); 256-token and cross rows do not."""
    import superdiff_tpu_torch.models.sd.unet as U

    seen = []
    real = U.flash_mha_eod

    def spy(qt, k, vt):
        seen.append((tuple(qt.shape), tuple(k.shape)))
        return real(qt, k, vt)

    monkeypatch.setattr(U, "flash_mha_eod", spy)
    _, _, net = unets
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 4), torch.tensor(3.0), torch.zeros(3, 77, 64))
    # 2 down + 3 up attention layers at 1024 tokens (head_dim 32/4 = 8);
    # the first runs at the latent batch, the rest at the context batch
    assert seen == [((1, 4, 8, 1024), (1, 4, 1024, 8))] + [((3, 4, 8, 1024), (3, 4, 1024, 8))] * 4


def test_dedup_equals_tiled_forward(unets):
    _, _, net = unets
    rng = np.random.default_rng(2)
    x = t(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    ctx = t(rng.standard_normal((6, 77, 64)).astype(np.float32))
    with torch.no_grad():
        a = net(x, torch.tensor(3.0), ctx)
        b = net(x.repeat(3, 1, 1, 1), torch.tensor(3.0), ctx)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_subpixel_upsample_equals_repeat_conv():
    torch.manual_seed(0)
    up = SubpixelUpsample(8, 6)
    x = torch.randn(2, 8, 5, 7)
    with torch.no_grad():
        a, b = up(x), up.repeat_forward(x)
    assert a.shape == (2, 6, 10, 14)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_timestep_embedding_matches_jax():
    from superdiff_tpu.models.sd.unet import sd_timestep_embedding as jax_emb

    ts = np.array([0.0, 1.0, 481.0, 999.0], np.float32)
    ref = np.asarray(jax_emb(jnp.asarray(ts), 320))
    got = sd_timestep_embedding(t(ts), 320).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
