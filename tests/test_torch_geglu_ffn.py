"""Port ``geglu_ffn_block`` (its plain version, CPU tensors) vs the JAX fused
FFN sub-block: ``_reference_block`` and ``geglu_ffn_block`` with the Pallas
kernel in interpret mode, exact erf gelu; and the port's forward-mode
derivative vs ``jax.jvp``.

C=64, F=256, M=256, fp32. The port keeps weights in PyTorch's Linear layout:
w1 (2F, C) value half first, w2 (C, F), the transposes of the JAX
function's. Tolerance 1e-5 against the reference; 2e-5 against the kernel,
whose erf is a polynomial (max gelu error 1.2e-6, ``geglu_ffn.py:45-78``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.ops.pallas import geglu_ffn as jffn
from superdiff_tpu_torch.ops import geglu_ffn
from superdiff_tpu_torch.ops.geglu_ffn import _reference_block, geglu_ffn_block

torch.set_num_threads(1)

M, C, F = 256, 64, 256


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, C)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w1 = (rng.standard_normal((C, 2 * F)) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * F)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / np.sqrt(F)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, gamma, beta, w1, b1, w2, b2


def _port_args(x, gamma, beta, w1, b1, w2, b2):
    return t(x), t(gamma), t(beta), t(w1.T), t(b1), t(w2.T), t(b2)


def _port(arrays):
    with torch.no_grad():
        return geglu_ffn_block(*_port_args(*arrays)).numpy()


def test_matches_jax_reference():
    arrays = _inputs(0)
    ref = jffn._reference_block(*map(jnp.asarray, arrays), 1e-5, False)
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_matches_pallas_kernel_interpret():
    arrays = _inputs(1)
    ref = jffn.geglu_ffn_block(*map(jnp.asarray, arrays), approximate=False,
                               interpret=True)
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_jvp_matches_jax():
    primals, tangents = _inputs(2), _inputs(3)
    _, ref = jax.jvp(lambda *a: jffn._reference_block(*a, 1e-5, False),
                     tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents)))
    _, got = torch.func.jvp(geglu_ffn_block, _port_args(*primals), _port_args(*tangents))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    args = _port_args(*_inputs(4))
    before = geglu_ffn_block.launches
    out = geglu_ffn_block(args[0].reshape(4, M // 4, C), *args[1:])
    assert geglu_ffn_block.launches == before
    assert out.shape == (4, M // 4, C)
    assert torch.equal(out.reshape(M, C), _reference_block(*args))
    with pytest.raises(ValueError, match="CUDA"):
        geglu_ffn._launch(*args, 1e-5)
