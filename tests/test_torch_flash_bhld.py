"""The plain versions behind ``flash_mha`` / ``flash_mha_bhld`` (what a CPU
tensor is handed to, and what the CUDA kernels are held against on the card)
vs the JAX Pallas kernels in interpret mode; and the entries' forward-mode
derivatives vs ``jax.jvp`` of the JAX entries.

B=1, H=2, head dim 40 (160 for the 576-token ``_kernel_mh`` row). Three input
types, each with its tolerance:

* fp32: every variant is the same function; 2e-5, as the JAX package's own
  kernel tests.
* bf16: outputs lie on the bf16 grid and both sides round the same fp32
  value up to reassociation noise, so they differ by at most one bf16 ulp of
  the largest output (2^-8 of it).
* fp32 q with bf16 k and v: p is rounded to bf16 but the output stays fp32,
  which is the only way to see WHERE a variant rounds: the fp32-summed and
  bf16-summed row sums differ by about 2^-9 / sqrt(lk), below the bf16 output
  grid. A p within an fp32 ulp of a bf16 rounding boundary may round the
  other way in the other framework (max error ~3e-5 on outputs ~0.2, in
  either mode), so the MEAN absolute error is held: measured 4e-8 against the
  matching JAX variant and 1.4e-6 against the other sum mode (2e-5 against
  the other kv block size for the multi-block loop); the limit is 2e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.ops.pallas import flash_attention as jfa
from superdiff_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

MEAN_TOL = 2e-7
BF16, F32 = "bfloat16", "float32"
DTYPES = {"fp32": (F32, F32), "bf16": (BF16, BF16), "mixed": (F32, BF16)}


def _inputs(l, d, seed=0, b=1, h=2):
    rng = np.random.default_rng(seed + l + d)
    return tuple(rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(3))


def _jax(arrays, kind, **kw):
    qd, kd = DTYPES[kind]
    q, k, v = arrays
    out = jfa.flash_mha_bhld(jnp.asarray(q, qd), jnp.asarray(k, kd), jnp.asarray(v, kd),
                             interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, kind, **kw):
    qd, kd = (getattr(torch, n) for n in DTYPES[kind])
    q, k, v = arrays
    with torch.no_grad():
        return fa.flash_mha_bhld(t(q).to(qd), t(k).to(kd), t(v).to(kd), **kw).float().numpy()


def _hold(got, ref, kind):
    scale = np.abs(ref).max()
    if kind == "fp32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    elif kind == "bf16":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-8 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * scale)
        assert np.abs(got - ref).mean() < MEAN_TOL


@pytest.fixture
def lever(monkeypatch):
    def set_impl(impl):
        monkeypatch.setattr(jfa, "_LONG_IMPL", impl)
        monkeypatch.setattr(fa, "_LONG_IMPL", impl)
    return set_impl


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("impl", sorted(fa._LONG_KERNELS))
def test_long_impl_plain_version_matches_pallas_kernel(lever, impl, kind):
    lever(impl)
    arrays = _inputs(2048, 40)
    _hold(_port(arrays, kind), _jax(arrays, kind), kind)


@pytest.mark.parametrize("impl,other", [("1block", "mxsum"), ("pvt1", "1block")])
def test_sum_modes_are_told_apart(monkeypatch, impl, other):
    """The mixed-dtype check does separate the two sum modes: the port under
    the other mode's lever misses the limit the matching one meets."""
    arrays = _inputs(2048, 40)
    monkeypatch.setattr(jfa, "_LONG_IMPL", impl)
    ref = _jax(arrays, "mixed")
    monkeypatch.setattr(fa, "_LONG_IMPL", other)
    assert np.abs(_port(arrays, "mixed") - ref).mean() > 3 * MEAN_TOL
    monkeypatch.setattr(fa, "_LONG_IMPL", impl)
    assert np.abs(_port(arrays, "mixed") - ref).mean() < MEAN_TOL


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("l,d", [(576, 160), (1024, 80)])
def test_kernel_mh_plain_version_matches_pallas_kernel(l, d, kind):
    assert fa._kernel_name(l, fa._blocks(l, l, None, None)[1]) == "_kernel_mh"
    arrays = _inputs(l, d)
    _hold(_port(arrays, kind), _jax(arrays, kind), kind)


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("l,kw,n_k", [(2048, {"block_k": 512}, 4), (4608, {}, 9)])
def test_multiblock_plain_version_matches_pallas_kernel(l, kw, n_k, kind):
    block_q, block_k = fa._blocks(l, l, None, kw.get("block_k"))
    assert l // block_k == n_k and fa._kernel_name(l, block_k) == "_kernel"
    arrays = _inputs(l, 40)
    _hold(_port(arrays, kind, **kw), _jax(arrays, kind, **kw), kind)


def test_multiblock_rounds_where_the_running_max_moves():
    """The loop must use JAX's block_k: with another one each p is rounded
    against another running max, which the mixed-dtype check sees."""
    arrays = _inputs(2048, 40)
    ref = _jax(arrays, "mixed", block_k=512)
    assert np.abs(_port(arrays, "mixed", block_k=1024) - ref).mean() > 3 * MEAN_TOL


def test_flash_mha_is_flash_mha_bhld_transposed():
    arrays = _inputs(2048, 40, seed=1)
    q, k, v = (t(a).bfloat16() for a in arrays)
    a = fa.flash_mha(*(x.transpose(1, 2) for x in (q, k, v)))
    assert a.shape == (1, 2048, 2, 40)
    assert torch.equal(a.transpose(1, 2), fa.flash_mha_bhld(q, k, v))
    ref = jfa.flash_mha(*(jnp.asarray(x, BF16).transpose(0, 2, 1, 3) for x in arrays),
                        interpret=True)
    _hold(a.float().numpy(), np.asarray(ref.astype(jnp.float32)), "bf16")


@pytest.mark.parametrize("entry,l,kw", [("flash_mha", 512, {}), ("flash_mha_bhld", 512, {}),
                                        ("flash_mha_bhld", 2048, {"block_k": 512}),
                                        ("flash_mha", 2048, {})])
def test_jvp_matches_jax(entry, l, kw):
    """Tangents go through the plain reference in both packages; fp32, 1e-4."""
    primals, tangents = _inputs(l, 16, seed=2), _inputs(l, 16, seed=3)
    if entry == "flash_mha":
        primals, tangents = (tuple(a.transpose(0, 2, 1, 3) for a in x)
                             for x in (primals, tangents))
    ref_o, ref_t = jax.jvp(lambda *a: getattr(jfa, entry)(*a, interpret=True, **kw),
                           tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents)))
    got_o, got_t = torch.func.jvp(lambda *a: getattr(fa, entry)(*a, **kw),
                                  tuple(map(t, primals)), tuple(map(t, tangents)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_and_cuda_is_required_to_launch():
    q, k, v = (t(a).bfloat16() for a in _inputs(2048, 40, seed=4))
    before = dict(fa.flash_mha_bhld.launches)
    out = fa.flash_mha_bhld(q, k, v)
    assert fa.flash_mha_bhld.launches == before and fa.flash_mha.launches is fa.flash_mha_bhld.launches
    assert torch.equal(out, fa._plain_1block(q, k, v, 40**-0.5, "bf16"))
    assert torch.equal(fa.flash_mha_bhld(q, k, v, block_k=512),
                       fa._plain_multiblock(q, k, v, 40**-0.5, 2048, 512))
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_bhld(q, k, v, 40**-0.5, "_kernel")


@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_multiblock_at_the_cards_kv_tile_matches_pallas_kernel(kind):
    """The card's online kernel rounds each p against the running maximum of
    its 128-row kv tiles: ``_plain_multiblock(block_k=128)``, which is the
    Pallas ``_kernel`` itself under ``block_k=128`` (a block size the JAX
    entry accepts). bf16: within one bf16 ulp of the largest output; mixed
    dtypes: the mean limit, which tells where the rounding happens."""
    arrays = _inputs(2048, 40, seed=5)
    ref = _jax(arrays, kind, block_k=128)
    qd, kd = (getattr(torch, n) for n in DTYPES[kind])
    q, k, v = (t(a).to(dt) for a, dt in zip(arrays, (qd, kd, kd)))
    with torch.no_grad():
        got = fa._plain_multiblock(q, k, v, 40**-0.5, 2048, 128).float().numpy()
    if kind == "bf16":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= ulp
    else:
        _hold(got, ref, kind)
    # the entry with that block_k takes the same plain version on the CPU
    np.testing.assert_array_equal(_port(arrays, kind, block_k=128), got)
