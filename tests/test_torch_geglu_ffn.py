"""Port ``geglu_ffn_block`` and ``geglu_ffn`` (their plain versions, CPU
tensors) vs the JAX fused FFN: ``_reference_block`` / ``_reference`` and
``geglu_ffn_block`` / ``geglu_ffn`` with the Pallas kernel in interpret mode,
for both gelu flavours (the exact erf, and tanh, JAX's default, which the
port's entries default to as well); and the port's forward-mode derivative
vs ``jax.jvp``.

C=64, F=256, M=256, fp32. The port keeps weights in PyTorch's Linear layout:
w1 (2F, C) value half first, w2 (C, F), the transposes of the JAX
function's. Tolerance 1e-5 against the reference; 2e-5 against the kernel,
whose erf is a polynomial (max gelu error 1.2e-6, ``geglu_ffn.py:45-78``).
The Hopper kernel's gelu is that polynomial: its plain copy ``_gelu_poly``
is held to JAX ``_gelu_kernel`` within 1e-6 (the same fp32 operations, at
most an ulp of |x| <= 8 apart) and to the exact erf gelu within 2e-6 on a
grid over [-8, 8]; the kernel's shape rule (C and F multiples of 64, any
M) is checked without a card.
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


def _port(arrays, approximate=False):
    with torch.no_grad():
        return geglu_ffn_block(*_port_args(*arrays), approximate=approximate).numpy()


def _unfused_args(x, gamma, beta, w1, b1, w2, b2):
    return x, w1, b1, w2, b2


def test_matches_jax_reference():
    arrays = _inputs(0)
    ref = jffn._reference_block(*map(jnp.asarray, arrays), 1e-5, False)
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_matches_pallas_kernel_interpret():
    arrays = _inputs(1)
    ref = jffn.geglu_ffn_block(*map(jnp.asarray, arrays), approximate=False,
                               interpret=True)
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_default_gelu_is_jax_default():
    """Both entries default to the tanh gelu, as JAX's do."""
    arrays = _inputs(5)
    ref = jffn.geglu_ffn_block(*map(jnp.asarray, arrays), interpret=True)
    with torch.no_grad():
        got = geglu_ffn_block(*_port_args(*arrays)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref = jffn.geglu_ffn(*map(jnp.asarray, _unfused_args(*arrays)), interpret=True)
    with torch.no_grad():
        got = geglu_ffn.geglu_ffn(*_unfused_args(*_port_args(*arrays))).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("approximate", [True, False])
def test_block_matches_jax_both_flavours(approximate):
    """The block against JAX's reference and its Pallas kernel (interpret):
    tanh within 1e-5 (the same fp32 formula), erf within 2e-5 of the
    kernel (its polynomial)."""
    arrays = _inputs(6)
    jarr = tuple(map(jnp.asarray, arrays))
    ref = jffn._reference_block(*jarr, 1e-5, approximate)
    kern = jffn.geglu_ffn_block(*jarr, approximate=approximate, interpret=True)
    got = _port(arrays, approximate)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5 if approximate else 2e-5)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("approximate", [True, False])
def test_unfused_matches_jax(approximate):
    """``geglu_ffn`` (no LN, no residual) against JAX's ``_reference`` and
    its ``geglu_ffn`` in interpret mode, leading dims flattened."""
    arrays = _unfused_args(*_inputs(7))
    jarr = tuple(map(jnp.asarray, arrays))
    ref = jffn._reference(*jarr, approximate)
    kern = jffn.geglu_ffn(jarr[0].reshape(4, M // 4, C), *jarr[1:], approximate=approximate,
                          interpret=True)
    args = _unfused_args(*_port_args(*_inputs(7)))
    with torch.no_grad():
        got = geglu_ffn.geglu_ffn(args[0].reshape(4, M // 4, C), *args[1:],
                                  approximate=approximate)
    assert got.shape == (4, M // 4, C)
    got = got.reshape(M, C).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5 if approximate else 2e-5)
    np.testing.assert_allclose(got, np.asarray(kern).reshape(M, C), rtol=2e-5, atol=2e-5)


def test_jvp_matches_jax():
    primals, tangents = _inputs(2), _inputs(3)
    _, ref = jax.jvp(lambda *a: jffn._reference_block(*a, 1e-5, False),
                     tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents)))
    _, got = torch.func.jvp(lambda *a: geglu_ffn_block(*a, approximate=False),
                            _port_args(*primals), _port_args(*tangents))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("approximate", [True, False])
def test_unfused_and_tanh_jvp_match_jax(approximate):
    primals, tangents = _inputs(8), _inputs(9)
    jp, jt = tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents))
    _, ref = jax.jvp(lambda *a: jffn._reference(*a, approximate), _unfused_args(*jp),
                     _unfused_args(*jt))
    _, got = torch.func.jvp(lambda *a: geglu_ffn.geglu_ffn(*a, approximate=approximate),
                            _unfused_args(*_port_args(*primals)),
                            _unfused_args(*_port_args(*tangents)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    _, ref = jax.jvp(lambda *a: jffn._reference_block(*a, 1e-5, True), jp, jt)
    _, got = torch.func.jvp(geglu_ffn_block, _port_args(*primals), _port_args(*tangents))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    args = _port_args(*_inputs(4))
    before = dict(geglu_ffn_block.launches), dict(geglu_ffn.geglu_ffn.launches)
    out = geglu_ffn_block(args[0].reshape(4, M // 4, C), *args[1:])
    unf = geglu_ffn.geglu_ffn(*_unfused_args(*args), approximate=False)
    assert (geglu_ffn_block.launches, geglu_ffn.geglu_ffn.launches) == before
    assert out.shape == (4, M // 4, C)
    assert torch.equal(out.reshape(M, C), _reference_block(*args))
    assert torch.equal(unf, geglu_ffn._reference(*_unfused_args(*args), approximate=False))
    with pytest.raises(ValueError, match="CUDA"):
        geglu_ffn._launch(*args, 1e-5, True, True)
    with pytest.raises(ValueError, match="CUDA"):
        geglu_ffn._launch(args[0], None, None, *_unfused_args(*args)[1:], 1e-5, False, False)


def _gelu_grid():
    return np.linspace(-8.0, 8.0, 16001, dtype=np.float32)


def test_gelu_poly_matches_pallas_polynomial():
    x = _gelu_grid()
    ref = np.asarray(jffn._gelu_kernel(jnp.asarray(x), False))
    got = geglu_ffn._gelu_poly(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_gelu_poly_matches_exact_gelu():
    x = torch.from_numpy(_gelu_grid())
    exact = torch.nn.functional.gelu(x.double()).float()
    np.testing.assert_allclose(geglu_ffn._gelu_poly(x).numpy(), exact.numpy(), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("m, c, f, ok", [
    (256, 64, 256, True), (1, 64, 256, True), (77, 128, 512, True), (0, 64, 256, True),
    (256, 96, 384, False), (256, 64, 200, False), (256, 32, 128, False),
    (256, 320, 1300, False)])
def test_shape_rule(m, c, f, ok):
    shapes = ((m, c), (2 * f, c), (c, f))
    if ok:
        assert geglu_ffn._check_shapes(*shapes) == (m, c, f)
    else:
        with pytest.raises(ValueError, match="multiples of 64"):
            geglu_ffn._check_shapes(*shapes)
