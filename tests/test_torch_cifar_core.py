"""Port VP-SDE core (schedules, N-model OR weights, VP Itô estimators,
renormalisation, the Rademacher probe and Hutchinson divergence) vs the JAX
package, fp32 on the CPU, 1e-5."""

import jax
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

T_GRID = np.linspace(1e-3, 1.0, 41, dtype=np.float32)
METHODS = ["log_alpha", "alpha", "log_sigma", "sigma", "dlog_alpha_dt",
           "dlog_sigma_dt", "beta"]


@pytest.mark.parametrize("name", ["VPSchedule", "CosineVPSchedule"])
def test_vp_schedules_match_jax(name):
    ref_s, got_s = getattr(jsched, name)(), getattr(schedules, name)()
    x0, eps = np.ones(41, np.float32), np.full(41, 0.5, np.float32)
    for method in METHODS:
        ref = np.asarray(getattr(ref_s, method)(jnp.asarray(T_GRID)))
        got = getattr(got_s, method)(t(T_GRID))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=method)
        # host floats take the same formulas in double precision
        f = getattr(got_s, method)(float(T_GRID[7]))
        assert isinstance(f, float)
        np.testing.assert_allclose(f, ref[7], rtol=1e-5, err_msg=method)
    np.testing.assert_allclose(got_s.marginal(t(x0), t(eps), t(T_GRID)).numpy(),
                               np.asarray(ref_s.marginal(x0, eps, jnp.asarray(T_GRID))),
                               rtol=1e-5, atol=1e-6)


def test_or_weights_and_renormalize_match_jax():
    rng = np.random.default_rng(0)
    logq = (1e-5 * rng.standard_normal((6, 3))).astype(np.float32)
    logq[0] = 0.0  # a tie
    for temperature in (1.0, 1e6):
        np.testing.assert_allclose(
            kappa.or_weights(t(logq), temperature).numpy(),
            np.asarray(jkappa.or_weights(jnp.asarray(logq), temperature)),
            rtol=1e-5, atol=1e-6)
    got = ito.renormalize_logq(t(logq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jito.renormalize_logq(logq)))
    assert torch.all(got.max(-1).values == 0)


def _vp_inputs(seed):
    rng = np.random.default_rng(seed)
    sscores = rng.standard_normal((3, 4, 8, 8, 3)).astype(np.float32)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    dx = (0.1 * rng.standard_normal((4, 8, 8, 3))).astype(np.float32)
    divs = rng.standard_normal((3, 4)).astype(np.float32)
    return sscores, x, dx, divs


@pytest.mark.parametrize("tt", [0.7, 0.013])
def test_vp_estimators_match_jax(tt):
    sscores, x, dx, divs = _vp_inputs(1)
    js, ps = jsched.VPSchedule(), schedules.VPSchedule()
    jt, pt = jnp.float32(tt), torch.tensor(tt, dtype=torch.float32)
    dt = np.float32(5e-3)
    ref = jito.dlogq_sde_vp(jnp.asarray(sscores), jnp.asarray(x), jnp.asarray(dx), jt, dt, js)
    got = ito.dlogq_sde_vp(t(sscores), t(x), t(dx), pt, torch.tensor(dt), ps)
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref = jito.dlogq_ode_vp(jnp.asarray(sscores), jnp.asarray(divs), jnp.asarray(x),
                            jnp.asarray(dx), jt, dt, js)
    got = ito.dlogq_ode_vp(t(sscores), t(divs), t(x), t(dx), pt, torch.tensor(dt), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_hutchinson_div_and_rademacher():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5, 5)).astype(np.float32)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    probe = ito.rademacher((3, 5), torch.Generator().manual_seed(0))
    assert set(probe.unique().tolist()) <= {-1.0, 1.0} and probe.dtype == torch.float32
    fn_j = lambda v: jnp.tanh(v @ a)  # noqa: E731
    ref_val, ref_div = jito.hutchinson_div(fn_j, jnp.asarray(x), jnp.asarray(probe.numpy()))
    got_val, got_div = ito.hutchinson_div(lambda v: torch.tanh(v @ t(a)), t(x), probe)
    np.testing.assert_allclose(got_val.numpy(), np.asarray(ref_val), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_div.numpy(), np.asarray(ref_div), rtol=1e-5, atol=1e-5)
    # a stacked (N, B, *event) oracle, as the ODE step uses it: one JVP, N
    # divergences, each the one of its own member
    stacked = lambda v: torch.stack([torch.tanh(v @ t(a)), 2.0 * v])  # noqa: E731
    val, div = ito.hutchinson_div(stacked, t(x), probe)
    assert val.shape == (2, 3, 5) and div.shape == (2, 3)
    np.testing.assert_allclose(div[0].numpy(), np.asarray(ref_div), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(div[1].numpy(), np.full(3, 10.0, np.float32))
    jprobe = np.asarray(jito.rademacher(jax.random.PRNGKey(0), (64,)))
    assert set(np.unique(jprobe)) == {-1.0, 1.0}



def test_sde_step_matches_jax():
    """``sde_step`` (the one SDE / OR step; on the CPU ``fused_sde_step``'s
    plain version) against JAX's ``sde_step`` with its plain epilogue
    (``fused_kernel=False``), on JAX's own normals regenerated from the key;
    logq, a renormalised difference of O(1e2) Itô sums here, within 1e-4
    of its largest magnitude."""
    from superdiff_tpu.core.superpose import SuperposeConfig as JConfig
    from superdiff_tpu.core.superpose import sde_step as jax_sde_step
    from superdiff_tpu_torch.core.superpose import SuperposeConfig, sde_step

    sscores, x, _, _ = _vp_inputs(3)
    logq = np.random.default_rng(4).standard_normal((4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, x.shape))
    jcfg = JConfig(n_steps=10, fused_kernel=False)
    cfg = SuperposeConfig(n_steps=10)
    tt, dt = np.float32(0.62), np.float32(0.01)
    ref_x, ref_q = jax_sde_step(key, jnp.asarray(x), jnp.asarray(logq), jnp.float32(tt),
                                jnp.float32(dt), lambda _t, _x: jnp.asarray(sscores),
                                jsched.VPSchedule(), jcfg)
    got_x, got_q = sde_step(t(eps), t(x), t(logq), torch.tensor(tt), torch.tensor(dt),
                            lambda _t, _x: t(sscores), schedules.VPSchedule(), cfg)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=1e-5, atol=1e-5)
    scale = np.abs(np.asarray(ref_q)).max()
    np.testing.assert_allclose(got_q.numpy() / scale, np.asarray(ref_q) / scale, rtol=0,
                               atol=1e-4)
