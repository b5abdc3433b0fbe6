"""Port ``fused_sde_step`` (its plain version, CPU tensors) vs the JAX fused
VP-SDE OR epilogue: ``fused_sde_step_reference`` and the Pallas kernel in
interpret mode.

Shapes: the JAX tests' (2, 16, 256) and (3, 10, 384), and the CIFAR main
path's (2, 100, 3072); logq with and without ties. fp32 tolerances as
``tests/test_pallas.py`` uses: rtol 1e-5 on x (elementwise), 1e-4 on logq (a
sum over D taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.core.schedules import VPSchedule as JaxVPSchedule
from superdiff_tpu.ops.pallas import fused_step as jax_step
from superdiff_tpu_torch.ops import fused_step
from superdiff_tpu_torch.ops.fused_step import fused_sde_step, fused_sde_step_reference

torch.set_num_threads(1)

SHAPES = [(2, 16, 256), (3, 10, 384), (2, 100, 3072)]


def _inputs(n, b, d, seed, ties=False):
    rng = np.random.default_rng(seed)
    sscores = rng.standard_normal((n, b, d)).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    logq = np.zeros((b, n), np.float32) if ties else (
        0.1 * rng.standard_normal((b, n))).astype(np.float32)
    sched, tt = JaxVPSchedule(), jnp.float32(0.5 - seed * 0.1)
    scal = [np.float32(v) for v in (sched.dlog_alpha_dt(tt), sched.beta(tt),
                                    sched.sigma(tt), 5e-3)]
    return (sscores, x, eps, logq), scal


def _check(got, ref):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5,
                               err_msg="x")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-4,
                               err_msg="logq")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_matches_jax_reference(shape, ties):
    arrays, scal = _inputs(*shape, seed=1, ties=ties)
    ref = jax_step.fused_sde_step_reference(*map(jnp.asarray, arrays), *scal)
    _check(fused_sde_step_reference(*map(t, arrays), *scal), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel_interpret(shape):
    arrays, scal = _inputs(*shape, seed=2)
    ref = jax_step.fused_sde_step_pallas(*map(jnp.asarray, arrays), *map(jnp.float32, scal),
                                         interpret=True)
    _check(fused_sde_step_reference(*map(t, arrays), *scal), ref)


def test_dispatcher_flattens_and_takes_the_plain_version_on_cpu():
    (s, x, eps, logq), scal = _inputs(2, 4, 3 * 8 * 8, seed=3)
    before = fused_sde_step.launches
    new_x, new_logq = fused_sde_step(t(s).reshape(2, 4, 8, 8, 3), t(x).reshape(4, 8, 8, 3),
                                     t(eps).reshape(4, 8, 8, 3), t(logq), *scal)
    ref_x, ref_logq = fused_sde_step_reference(t(s), t(x), t(eps), t(logq), *scal)
    assert fused_sde_step.launches == before
    assert new_x.shape == (4, 8, 8, 3)
    assert torch.equal(new_x.reshape(4, -1), ref_x) and torch.equal(new_logq, ref_logq)
    assert torch.all(new_logq.max(-1).values == 0)


def test_launch_path_rejects_cpu_tensors():
    """The kernel path never falls back: host tensors are refused there."""
    (s, x, eps, logq), scal = _inputs(2, 4, 64, seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step._launch(t(s), t(x), t(eps), t(logq), *scal, 1e6)


@pytest.mark.parametrize("ties", [False, True])
def test_tensor_scalars_match_pallas_kernel_interpret(ties):
    """da, beta, sigma, dt as 0-d tensor views of one step-table row (what
    the sampler passes): the Pallas kernel's answer, and bit for bit the
    answer of the same scalars as floats."""
    arrays, scal = _inputs(2, 100, 3072, seed=3, ties=ties)
    ref = jax_step.fused_sde_step_pallas(*map(jnp.asarray, arrays), *map(jnp.float32, scal),
                                         interpret=True)
    row = torch.tensor([0.5] + [float(v) for v in scal])[1:]
    got = fused_sde_step(*map(t, arrays), *row.unbind())
    _check(got, ref)
    floats = fused_sde_step(*map(t, arrays), *map(float, scal))
    assert torch.equal(got[0], floats[0]) and torch.equal(got[1], floats[1])
