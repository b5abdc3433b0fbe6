"""Port ``flash_mha_eod`` (its plain version, CPU tensors) vs the JAX d-major
attention: ``_reference_eod`` and ``flash_mha_eod`` with the pvtd Pallas
kernel in interpret mode; and the port's forward-mode derivative vs
``jax.jvp`` of ``_reference_eod``.

B=2, H=2, L=512, head dims 40 and 80. Tolerances: fp32 1e-5. bf16 inputs:
2e-2 against the JAX reference (both round the logits and the probabilities
to bf16, in different orders) and 3e-2 against the kernel (which also
rounds q * scale to bf16 and sums bf16 probabilities).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.ops.pallas import flash_attention as jfa
from superdiff_tpu_torch.ops import flash_attention
from superdiff_tpu_torch.ops.flash_attention import _reference_eod, flash_mha_eod

torch.set_num_threads(1)

B, H, L = 2, 2, 512


def _inputs(d, seed=0):
    rng = np.random.default_rng(seed + d)
    qt = rng.standard_normal((B, H, d, L)).astype(np.float32)
    k = rng.standard_normal((B, H, L, d)).astype(np.float32)
    vt = rng.standard_normal((B, H, d, L)).astype(np.float32)
    return qt, k, vt


def _port(arrays, dtype):
    with torch.no_grad():
        return flash_mha_eod(*(t(a).to(dtype) for a in arrays)).float().numpy()


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_matches_jax_reference(d, dtype, tol):
    arrays = _inputs(d)
    ref = jfa._reference_eod(*(jnp.asarray(a, dtype) for a in arrays), d**-0.5)
    got = _port(arrays, getattr(torch, dtype))
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_matches_pallas_kernel_interpret(d, dtype, tol):
    arrays = _inputs(d, seed=1)
    ref = jfa.flash_mha_eod(*(jnp.asarray(a, dtype) for a in arrays), interpret=True)
    got = _port(arrays, getattr(torch, dtype))
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [40, 80])
def test_jvp_matches_jax(d):
    primals = _inputs(d, seed=2)
    tangents = _inputs(d, seed=3)
    _, ref = jax.jvp(lambda a, b, c: jfa._reference_eod(a, b, c, d**-0.5),
                     tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents)))
    _, got = torch.func.jvp(flash_mha_eod, tuple(map(t, primals)), tuple(map(t, tangents)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    qt, k, vt = (t(a) for a in _inputs(40, seed=4))
    before = flash_mha_eod.launches
    out = flash_mha_eod(qt, k, vt)
    assert flash_mha_eod.launches == before
    assert torch.equal(out, _reference_eod(qt, k, vt, 40**-0.5))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._launch(qt, k, vt, 40**-0.5)
