"""Port SD UNet under each ``attn_impl`` vs the JAX SDUNet under the same
``attn_impl``, tiny config, fp32 on the CPU, one set of weights.

32x32 latents give 1024-token self-attention at the first level (the flash
family's kernels: the JAX side runs its Pallas kernels in interpret mode,
the port their plain versions), 256- and 64-token rows below it and 77-token
cross-attention everywhere. ``flash_nat`` (every row to the packed
``_kernel_mh_nat``) is held in ``test_torch_sd_unet_nat.py`` and the plain
``einsum`` and ``dpa`` in ``test_torch_sd_unet_plain.py``, which keeps each
file under a minute; the tiny UNet never reaches
``_kernel_cross_packed`` (its rows are too short): ``test_torch_flash_packed.py``
holds a ``TransformerBlock`` under that lever. fp32 tolerance: 1e-5 relative
to the output's largest magnitude, as ``test_torch_sd_unet.py``.
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
from superdiff_tpu_torch.models.sd import unet as U
from superdiff_tpu_torch.models.sd.unet import ATTN_IMPLS, SDUNet, SDUNetConfig

torch.set_num_threads(1)


# flash_nat: test_torch_sd_unet_nat.py; einsum and dpa: test_torch_sd_unet_plain.py
IMPLS = [impl for impl in ATTN_IMPLS if impl.startswith("flash") and impl != "flash_nat"]


@pytest.fixture(scope="module")
def params():
    jnet = JaxSDUNet(dataclasses.replace(JaxSDUNetConfig.tiny(), ffn_impl="einsum"),
                     dtype=jnp.float32)
    return draw_params(jnet, jnp.zeros((1, 16, 16, 4)), jnp.zeros(()), jnp.zeros((1, 77, 64)))


@pytest.mark.parametrize("attn_impl", IMPLS)
def test_unet_matches_jax_under_attn_impl(params, attn_impl):
    check_unet_under_attn_impl(params, attn_impl)


def check_unet_under_attn_impl(params, attn_impl):
    """One forward of both UNets under ``attn_impl`` on the same inputs."""
    jcfg = dataclasses.replace(JaxSDUNetConfig.tiny(), attn_impl=attn_impl, ffn_impl="einsum")
    jnet = JaxSDUNet(jcfg, dtype=jnp.float32)
    net = carry(SDUNet(dataclasses.replace(SDUNetConfig.tiny(), attn_impl=attn_impl),
                       dtype=torch.float32), params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    ctx = rng.standard_normal((3, 77, 64)).astype(np.float32)
    # jitted: op by op, a file's first JAX forward compiles every primitive
    # (half a minute on the CPU with the Pallas kernels in interpret mode)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, x, np.float32(481.0), ctx))
    with torch.no_grad():
        got = net(t(x), torch.tensor(481.0), t(ctx)).numpy()
    assert got.shape == ref.shape == (3, 32, 32, 4)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn_impl,want", [
    ("flash_eod", {"flash_mha_eod": 5, "flash_mha": 27}),
    ("flash_eo", {"flash_mha_bhld": 5, "flash_mha": 27}),
    ("flash", {"flash_mha": 32}),
    ("flash_nat", {"flash_mha": 32}),
    ("einsum", {}),
    ("dpa", {}),
])
def test_rows_route_by_attn_impl(params, monkeypatch, attn_impl, want):
    """16 transformer blocks, each with a self- and a cross-attention, at a
    32x32 latent: the 5 self-attention rows of 1024 tokens take the long
    entry of their ``attn_impl``; the other 27 rows of the flash family go
    through ``flash_mha``."""
    seen = {}
    for name in ("flash_mha", "flash_mha_bhld", "flash_mha_eod"):
        real = getattr(U, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(U, name, spy)
    net = carry(SDUNet(dataclasses.replace(SDUNetConfig.tiny(), attn_impl=attn_impl),
                       dtype=torch.float32), params)
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 4), torch.tensor(3.0), torch.zeros(3, 77, 64))
    assert seen == want


def test_flash_nat_and_unknown_attn_impl_raise():
    """``flash_nat`` is a name like the others now; an unknown one raises."""
    assert SDUNetConfig(attn_impl="flash_nat").attn_impl in ATTN_IMPLS
    with pytest.raises(ValueError, match="attn_impl"):
        SDUNetConfig(attn_impl="sdpa")

