"""Port core (sigma grid, OR kappa, sigma-space Itô estimators) vs the JAX
package, fp32 on the CPU."""

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
