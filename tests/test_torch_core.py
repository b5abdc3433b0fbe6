"""Port core (sigma grid, OR and AND kappa, sigma-space Itô estimators) vs
the JAX package, fp32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.core import ito as jito
from superdiff_tpu.core import kappa as jkappa
from superdiff_tpu.core import schedules as jsched
from superdiff_tpu_torch.core import ito, kappa, schedules

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [3, 50, 1000])
def test_sigma_grid_matches_jax(steps):
    ref = jsched.SigmaGrid.euler_discrete(steps)
    got = schedules.SigmaGrid.euler_discrete(steps)
    assert got.timesteps == ref.timesteps and got.sigmas == ref.sigmas
    assert got.init_noise_sigma == ref.init_noise_sigma
    for a, b in zip(got.as_arrays(), ref.as_arrays()):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(schedules.ddpm_alphas_cumprod(), jsched.ddpm_alphas_cumprod())


@pytest.mark.parametrize("temperature,logp", [(1.0, 0.0), (50.0, -0.3)])
def test_kappa_or_matches_jax(temperature, logp):
    rng = np.random.default_rng(0)
    a, b = (200 * rng.standard_normal(7)).astype(np.float32), (200 * rng.standard_normal(7)).astype(np.float32)
    ref = jkappa.kappa_or(jnp.asarray(a), jnp.asarray(b), temperature, logp)
    got = kappa.kappa_or(t(a), t(b), temperature, logp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["dlogq_sde_sigma_space", "dlogq_sde_sigma_space_or"])
def test_sigma_space_estimators_match_jax(name):
    rng = np.random.default_rng(1)
    vels = rng.standard_normal((2, 3, 8, 8, 4)).astype(np.float32)
    dx = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    sigma, dsigma = np.float32(3.2), np.float32(-0.4)
    ref = getattr(jito, name)(jnp.asarray(vels), jnp.asarray(dx), sigma, dsigma)
    got = getattr(ito, name)(t(vels), t(dx), torch.tensor(sigma), torch.tensor(dsigma))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _velocities(seed, shape=(3, 8, 8, 4)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("lift", [0.0, 0.7])
def test_kappa_and_sde_matches_jax(lift):
    va, vb, dx_ind, _ = _velocities(2)
    sigma, dsigma = np.float32(3.2), np.float32(-0.4)
    ref = jkappa.kappa_and_sde(*map(jnp.asarray, (va, vb, dx_ind)), sigma, dsigma, 7.5, 50, lift)
    got = kappa.kappa_and_sde(t(va), t(vb), t(dx_ind), torch.tensor(sigma),
                              torch.tensor(dsigma), 7.5, 50, lift)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lift", [0.0, 0.7])
def test_kappa_and_ode_matches_jax(lift):
    va, vb, vu, _ = _velocities(3)
    rng = np.random.default_rng(4)
    da, db = (rng.standard_normal(3).astype(np.float32) * 30 for _ in range(2))
    sigma, dsigma = np.float32(3.2), np.float32(-0.4)
    ref = jkappa.kappa_and_ode(*map(jnp.asarray, (va, vb, da, db, vu)), sigma, dsigma,
                               7.5, 50, lift)
    got = kappa.kappa_and_ode(t(va), t(vb), t(da), t(db), t(vu), torch.tensor(sigma),
                              torch.tensor(dsigma), 7.5, 50, lift)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_and_kappas_sum_in_fp32_on_bf16_velocities():
    """bf16 velocities are summed in fp32, as ``_sum_event`` does."""
    va, vb, dx_ind, vu = _velocities(5, (2, 16, 16, 4))
    bf = lambda a: t(a).bfloat16()
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    sigma, dsigma = np.float32(3.2), np.float32(-0.4)
    ref = jkappa.kappa_and_sde(jb(va), jb(vb), jb(dx_ind), sigma, dsigma, 7.5, 50)
    got = kappa.kappa_and_sde(bf(va), bf(vb), bf(dx_ind), torch.tensor(sigma),
                              torch.tensor(dsigma), 7.5, 50)
    assert got.dtype == torch.float32
    # the elementwise products are rounded to bf16 in both; the sums are fp32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-3)


def test_dlogq_ode_sigma_space_matches_jax():
    rng = np.random.default_rng(6)
    vels = rng.standard_normal((2, 3, 8, 8, 4)).astype(np.float32)
    divs = (30 * rng.standard_normal((2, 3))).astype(np.float32)
    vf = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    sigma, dsigma = np.float32(3.2), np.float32(-0.4)
    ref = jito.dlogq_ode_sigma_space(jnp.asarray(vels), jnp.asarray(divs), jnp.asarray(vf),
                                     sigma, dsigma)
    got = ito.dlogq_ode_sigma_space(t(vels), t(divs), t(vf), torch.tensor(sigma),
                                    torch.tensor(dsigma))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_rademacher_probes_are_plus_minus_one():
    g = torch.Generator().manual_seed(0)
    p = ito.rademacher((4, 8, 8, 4), g)
    assert p.dtype == torch.float32 and set(p.unique().tolist()) == {-1.0, 1.0}
