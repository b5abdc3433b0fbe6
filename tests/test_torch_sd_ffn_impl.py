"""The port's ``SDUNetConfig.ffn_impl="einsum"`` (plain fp32 LayerNorm, GEGLU
projection, exact gelu and ``ff_out`` Linear over the fused FFN's
parameters) vs JAX's ``ffn_impl="einsum"``, fp32 on the CPU: one
transformer block, and a forward of the tiny UNet.

Tolerance: 1e-5 of the output's largest magnitude (XLA and PyTorch take
the fp32 sums in other orders), as ``tests/test_torch_sd_unet.py``.
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
from superdiff_tpu.models.sd.unet import TransformerBlock as JaxTransformerBlock
from superdiff_tpu_torch.models.sd.unet import SDUNet, SDUNetConfig, TransformerBlock

torch.set_num_threads(1)

ATOL = 1e-5


def _close(got, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def blocks():
    jblk = JaxTransformerBlock(32, 4, 16, dtype=jnp.float32, ffn_impl="einsum",
                               attn_impl="einsum")
    params = draw_params(jblk, jnp.zeros((1, 64, 32)), jnp.zeros((1, 77, 16)), seed=5)
    ports = {impl: carry(TransformerBlock(32, 4, 16, dtype=torch.float32, attn_impl="einsum",
                                          ffn_impl=impl), params)
             for impl in ("einsum", "fused")}
    return jblk, params, ports


def _block_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 64, 32)).astype(np.float32),
            rng.standard_normal((2, 77, 16)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_einsum_ffn_block_matches_jax(blocks, seed):
    jblk, params, ports = blocks
    x, ctx = _block_inputs(seed)
    ref = np.asarray(jblk.apply({"params": params}, x, ctx))
    with torch.no_grad():
        got = ports["einsum"](t(x), t(ctx)).numpy()
    _close(got, ref)


def test_einsum_ffn_block_matches_fused_plain_version(blocks):
    """Same parameters, same function: the fused block's plain version (the
    CPU path of ``geglu_ffn_block``, exact gelu in fp32) agrees with the
    einsum lowering at fp32."""
    _, _, ports = blocks
    x, ctx = _block_inputs(2)
    with torch.no_grad():
        a = ports["einsum"](t(x), t(ctx)).numpy()
        b = ports["fused"](t(x), t(ctx)).numpy()
    _close(a, b)


def test_einsum_ffn_does_not_reach_the_fused_block(blocks, monkeypatch):
    import superdiff_tpu_torch.models.sd.unet as U

    def refuse(*a, **k):
        raise AssertionError("ffn_impl='einsum' called geglu_ffn_block")

    monkeypatch.setattr(U, "geglu_ffn_block", refuse)
    _, _, ports = blocks
    x, ctx = _block_inputs(3)
    with torch.no_grad():
        ports["einsum"](t(x), t(ctx))


@pytest.mark.parametrize("dedup", [True, False])
def test_tiny_unet_einsum_ffn_matches_jax(dedup):
    jcfg = dataclasses.replace(JaxSDUNetConfig.tiny(), attn_impl="einsum", ffn_impl="einsum")
    jnet = JaxSDUNet(jcfg, dtype=jnp.float32)
    params = draw_params(jnet, jnp.zeros((1, 16, 16, 4)), jnp.zeros(()),
                         jnp.zeros((1, 77, 64)), seed=6)
    cfg = dataclasses.replace(SDUNetConfig.tiny(), attn_impl="einsum", ffn_impl="einsum")
    net = carry(SDUNet(cfg, dtype=torch.float32), params)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1 if dedup else 3, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((3, 77, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, *a: jnet.apply({"params": p}, *a))(
        params, x, np.float32(481.0), ctx))
    with torch.no_grad():
        got = net(t(x), torch.tensor(481.0), t(ctx)).numpy()
    assert got.shape == ref.shape == (3, 16, 16, 4)
    _close(got, ref)


def test_unknown_ffn_impl_is_refused():
    with pytest.raises(ValueError, match="ffn_impl"):
        SDUNetConfig(ffn_impl="pallas")


def test_embedding_frequencies_are_a_non_persistent_buffer():
    """The timestep frequencies and the upsampler's phase taps live on the
    module (no host copy per forward) and stay out of the state dict."""
    net = SDUNet(SDUNetConfig.tiny(), dtype=torch.float32)
    names = {n for n, _ in net.named_buffers()}
    assert "temb_freqs" in names and "up_0_upsample.phase_taps" in names
    assert not names & set(net.state_dict())
