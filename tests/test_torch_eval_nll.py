"""The port's SD ODE likelihood (``eval/nll.py``) against the JAX package's,
fp32 on the CPU, with JAX's Rademacher probes handed in (forward step i
draws from ``fold_in(key, i)``, reverse step i from ``fold_in(key, n + i)``).

* ``gaussian_base_logp``: rtol 1e-6.
* ``ode_nll`` over an analytic, well-conditioned velocity field written in
  both frameworks, unguided and guided (the CFG forward, the conditional
  reverse with its correction term): all five outputs within 1e-5 of their
  largest element (the port lands 5.3e-7 from jitted JAX at most, as far
  as JAX jitted lands from JAX op by op; the latents' elements near 0
  after the round trip through sigma 14.6 carry that absolute error).
* ``ode_nll`` through the tiny SD UNet (the golden config's widths, fp32,
  einsum attention / FFN in JAX, the port's plain kernels on the CPU),
  2 grid steps, unguided, JAX jitted. Each output is held, relative to its
  largest element, to a tolerance no looser than twice JAX's own jitted
  against op-by-op difference on this case (measured on this host, like
  the port's distance):

  ==================  ======================  ==========  ==============
  output              JAX jit vs op by op     tolerance   port vs JAX
  ==================  ======================  ==========  ==============
  ll                  6.5e-4                  1.2e-3      2.2e-4
  ll_path             1.24e-2                 2e-2        4.1e-3
  ll_forward_path     6.5e-5                  1.2e-4      9.7e-5
  ll_base             1.6e-7                  3e-7        1.6e-7
  latents_end         7.5e-5                  1.4e-4      1.2e-5
  ==================  ======================  ==========  ==============

  The divergences are fp32 tangents through the UNet's norms (ROADMAP C4):
  ``ll_path`` carries their noise, in either framework.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, draw_params

from superdiff_tpu.core import ito as jito
from superdiff_tpu.core.schedules import SigmaGrid as JGrid
from superdiff_tpu.eval import nll as jnll
from superdiff_tpu.models.sd import unet as junet
from superdiff_tpu_torch.core.schedules import SigmaGrid
from superdiff_tpu_torch.eval import nll
from superdiff_tpu_torch.models.sd.unet import SDUNet, SDUNetConfig

torch.set_num_threads(1)

KEYS = ("ll", "ll_path", "ll_forward_path", "ll_base", "latents_end")


def _probes(key, shape, n):
    return np.stack([np.asarray(jito.rademacher(jax.random.fold_in(key, i), shape))
                     for i in range(2 * n)])


def _close(got, ref, tol, what):
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


def test_gaussian_base_logp_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 8, 8, 4)).astype(np.float32)
    s = JGrid.euler_discrete(10).init_noise_sigma
    ref = np.asarray(jnll.gaussian_base_logp(jnp.asarray(x), s))
    got = nll.gaussian_base_logp(torch.from_numpy(x), s).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _jvel(x, t, sigma, c):
    a = 0.5 / (1.0 + sigma**2)
    return a * x + 0.1 * jnp.tanh(0.7 * x + c[:, None, None, :]) + 1e-3 * t


def _tvel(x, t, sigma, c):
    a = 0.5 / (1.0 + sigma**2)
    return a * x + 0.1 * torch.tanh(0.7 * x + c[:, None, None, :]) + 1e-3 * t


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
def test_ode_nll_analytic_field_matches_jax(guided):
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    c_obj, c_unc = (rng.standard_normal((2, 3)).astype(np.float32) for _ in range(2))
    n, key = 6, jax.random.PRNGKey(2)
    jg = (jnp.asarray(c_obj), jnp.asarray(c_unc), 3.0) if guided else None
    ref = jax.jit(lambda l, k: jnll.ode_nll(_jvel, jnp.asarray(c_obj), l,
                                            JGrid.euler_discrete(n), k, guidance=jg)
                  )(jnp.asarray(lat), key)
    tg = (torch.from_numpy(c_obj), torch.from_numpy(c_unc), 3.0) if guided else None
    got = nll.ode_nll(_tvel, torch.from_numpy(c_obj), torch.from_numpy(lat),
                      SigmaGrid.euler_discrete(n),
                      probes=torch.from_numpy(_probes(key, lat.shape, n)), guidance=tg)
    assert set(got) == set(ref)
    for k in KEYS:
        _close(got[k].numpy(), np.asarray(ref[k]), 1e-5, k)
    if guided:
        assert np.all(got["ll_forward_path"].numpy() == 0)


def test_ode_nll_draws_probes_from_a_generator():
    lat = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 4, 3))
                           .astype(np.float32))
    c = torch.zeros(2, 3)
    grid = SigmaGrid.euler_discrete(3)
    a, b = (nll.ode_nll(_tvel, c, lat, grid, generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    for k in KEYS:
        assert torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all()


TINY_TOL = {"ll": 1.2e-3, "ll_path": 2e-2, "ll_forward_path": 1.2e-4, "ll_base": 3e-7,
            "latents_end": 1.4e-4}


def test_ode_nll_tiny_sd_unet_matches_jax():
    ucfg = dataclasses.replace(junet.SDUNetConfig.tiny(), attn_impl="einsum",
                               ffn_impl="einsum", upsample_impl="repeat")
    unet = junet.SDUNet(ucfg, dtype=jnp.float32)
    params = draw_params(unet, jnp.zeros((1, 16, 16, 4)), jnp.zeros(()),
                         jnp.zeros((1, 77, 64)), seed=1)
    port = carry(SDUNet(dataclasses.replace(SDUNetConfig.tiny(), upsample_impl="repeat"),
                        dtype=torch.float32), params).requires_grad_(False)
    rng = np.random.default_rng(0)
    lat = (0.5 * rng.standard_normal((2, 8, 8, 4))).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    n, key = 2, jax.random.PRNGKey(5)

    def jvel(x, t, sigma, c):
        return unet.apply({"params": params}, x / jnp.sqrt(sigma**2 + 1.0), t, c)

    def tvel(x, t, sigma, c):
        return port(x / torch.sqrt(sigma**2 + 1.0), t, c)

    ref = jax.jit(lambda l, k: jnll.ode_nll(jvel, jnp.asarray(ctx), l,
                                            JGrid.euler_discrete(n), k))(jnp.asarray(lat), key)
    got = nll.ode_nll(tvel, torch.from_numpy(ctx), torch.from_numpy(lat),
                      SigmaGrid.euler_discrete(n),
                      probes=torch.from_numpy(_probes(key, lat.shape, n)))
    for k in KEYS:
        _close(got[k].numpy(), np.asarray(ref[k]), TINY_TOL[k], k)
