"""Port ``sd_or_step`` (its plain version, CPU tensors) vs the JAX OR epilogue:
``sd_or_step_reference`` and the Pallas kernel in interpret mode.

Odd batch, 512 px rows (D = 64*64*4), fp32. Tolerance: rtol 1e-5 on x and
kappa (elementwise fp32), 1e-4 on ll (a sum over D taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.ops.pallas import sd_fused_step as jax_step
from superdiff_tpu_torch.ops import sd_fused_step
from superdiff_tpu_torch.ops.sd_fused_step import sd_or_step, sd_or_step_reference

torch.set_num_threads(1)

B, D = 3, 64 * 64 * 4
KW = dict(temperature=1.3, logp=0.2, guidance=7.5)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((B, D)).astype(np.float32) for _ in range(5)]
    ll = (3 * rng.standard_normal((B, 2))).astype(np.float32)
    return rows, ll, np.float32(14.6146), np.float32(-0.3279)


def _port(rows, ll, sigma, dsigma):
    return [a.numpy() for a in sd_or_step(*map(t, rows), t(ll), torch.tensor(sigma),
                                          torch.tensor(dsigma), **KW)]


def _check(got, ref):
    for name, g, r, rtol in zip(("x", "ll", "kappa"), got, ref, (1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=rtol, atol=rtol, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_reference(seed):
    rows, ll, sigma, dsigma = _inputs(seed)
    ref = jax_step.sd_or_step_reference(*map(jnp.asarray, rows), jnp.asarray(ll),
                                        sigma, dsigma, **KW)
    _check(_port(rows, ll, sigma, dsigma), ref)


def test_matches_pallas_kernel_interpret():
    rows, ll, sigma, dsigma = _inputs(2)
    ref = jax_step.sd_or_step_pallas(*map(jnp.asarray, rows), jnp.asarray(ll),
                                     jnp.float32(sigma), jnp.float32(dsigma),
                                     interpret=True, **KW)
    _check(_port(rows, ll, sigma, dsigma), ref)


def test_cpu_tensors_take_the_plain_version():
    rows, ll, sigma, dsigma = _inputs(3)
    before = sd_or_step.launches
    a = sd_or_step(*map(t, rows), t(ll), sigma, dsigma, **KW)
    b = sd_or_step_reference(*map(t, rows), t(ll), sigma, dsigma, **KW)
    assert sd_or_step.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_launch_path_rejects_cpu_tensors():
    """The kernel path never falls back: host tensors are refused there."""
    rows, ll, sigma, dsigma = _inputs(4)
    with pytest.raises(ValueError, match="CUDA"):
        sd_fused_step._launch(*map(t, rows), t(ll), sigma, dsigma, 1.0, 0.0, 7.5)


def test_tensor_and_float_scalars_agree():
    """sigma / dsigma as 0-d tensors (views of a step table, what the
    sampler passes) or as floats: the same result, bit for bit."""
    rows, ll, sigma, dsigma = _inputs(5)
    table = torch.tensor([[0.5, sigma, dsigma]])
    a = sd_or_step(*map(t, rows), t(ll), *table[0, 1:].unbind(), **KW)
    b = sd_or_step(*map(t, rows), t(ll), float(sigma), float(dsigma), **KW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tensor_scalars_match_pallas_kernel_interpret():
    rows, ll, sigma, dsigma = _inputs(6)
    ref = jax_step.sd_or_step_pallas(*map(jnp.asarray, rows), jnp.asarray(ll),
                                     jnp.float32(sigma), jnp.float32(dsigma),
                                     interpret=True, **KW)
    table = torch.tensor([sigma, dsigma])
    got = sd_or_step(*map(t, rows), t(ll), table[0], table[1], **KW)
    _check([a.numpy() for a in got], ref)


def test_device_scalars_take_host_values_in_one_buffer():
    """Host values (floats, CPU tensors) become 0-d fp32 views of one small
    buffer on the target device, with their values."""
    from superdiff_tpu_torch.ops import _build

    vals = _build.device_scalars("test", torch.device("cpu"), 14.6146, torch.tensor(-0.25))
    assert [v.shape for v in vals] == [(), ()]
    assert all(v.dtype == torch.float32 for v in vals)
    assert vals[0].item() == np.float32(14.6146) and vals[1].item() == -0.25
    assert vals[0].untyped_storage().data_ptr() == vals[1].untyped_storage().data_ptr()
