"""The plain versions of the packed-layout kernels (``_kernel_mh_nat``,
``_kernel_cross_packed``: what a CPU tensor is handed to, and what the CUDA
kernel is held against on the card) vs the JAX Pallas kernels in interpret
mode, on (B, H, L, D) views of packed (B, L, H*D) tensors; and the
forward-mode derivatives of ``flash_mha`` under the packed-layout levers vs
``jax.jvp`` of the JAX entry; and an SD ``TransformerBlock`` under
``_CROSS_IMPL="xpk"`` (fp32, 1e-5 of the largest output), since the tiny UNet
of the other SD tests never reaches ``_kernel_cross_packed``.

Three input types, each with its tolerance (as ``test_torch_flash_bhld.py``):

* fp32: the same function; 2e-5.
* bf16: within one bf16 ulp of the largest output (both round the same
  fp32 value, up to reassociation noise). For ``_kernel_cross_packed`` the
  outputs are equal bit for bit but for 2e-5 to 4e-4 of them, which land
  one bf16 ulp off through the fp32 summation order of the matmuls: under
  1e-3 of the outputs may differ. Leaving out either of its two roundings
  (the zero shift, the bf16 denominator) moves 25 to 57 % of them.
* fp32 q with bf16 k and v (p is rounded, the output is not): mean absolute
  error under 5e-7 of the largest output (measured 2e-7; summing the bf16 p
  instead of the fp32 p gives 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, draw_params, t

from superdiff_tpu.models.sd.unet import TransformerBlock as JaxTransformerBlock
from superdiff_tpu.ops.pallas import flash_attention as jfa
from superdiff_tpu_torch.models.sd.unet import TransformerBlock
from superdiff_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

LOG2_E = 1.4426950408889634
MEAN_TOL = 5e-7  # of the largest output
MISMATCH_TOL = 1e-3  # share of bf16 outputs off by one ulp (_kernel_cross_packed)
DTYPES = {"fp32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
          "mixed": ("float32", "bfloat16")}


def _inputs(lq, lk, h, d, seed=0, b=2):
    """q (B, Lq, H, D), k and v (B, Lk, H, D) as numpy fp32."""
    rng = np.random.default_rng(seed + 7 * lq + 3 * lk + d)
    return (rng.standard_normal((b, lq, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32))


def _jax(fn, arrays, kind):
    qd, kd = DTYPES[kind]
    q, k, v = arrays
    d = q.shape[3]
    out = fn(jnp.asarray(q, qd), jnp.asarray(k, kd), jnp.asarray(v, kd),
             d ** -0.5 * LOG2_E, 64, True)
    return np.asarray(out.astype(jnp.float32))


def _packed_views(arrays, kind):
    """(B, H, L, D) views of packed (B, L, H*D) torch tensors."""
    qd, kd = (getattr(torch, n) for n in DTYPES[kind])
    views = []
    for a, dt in zip(arrays, (qd, kd, kd)):
        b, l, h, d = a.shape
        packed = t(a.reshape(b, l, h * d)).to(dt)
        views.append(packed.view(b, l, h, d).transpose(1, 2))
    return views


def _port(plain, arrays, kind, **kw):
    q, k, v = _packed_views(arrays, kind)
    out = plain(q, k, v, q.shape[3] ** -0.5, **kw)
    return out.transpose(1, 2).float().numpy()


def _mismatch(got, ref):
    return np.mean(got != ref)


def _hold(got, ref, kind, nearly_exact=False):
    scale = np.abs(ref).max()
    if kind == "fp32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    elif kind == "bf16":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-8 * scale)
        assert not nearly_exact or _mismatch(got, ref) < MISMATCH_TOL
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * scale)
        assert np.abs(got - ref).mean() < MEAN_TOL * scale


# (lq, lk, heads, head dim): the 77-token text cross-attention, kv a multiple
# of the 64-row kv tile, the 128 and 256 kv blocks
NAT_SHAPES = [(256, 77, 2, 40), (128, 64, 4, 8), (256, 128, 2, 16), (128, 256, 2, 32),
              (64, 77, 4, 24)]
XPK_SHAPES = [(256, 77, 2, 40), (128, 64, 4, 8), (256, 128, 2, 16), (128, 77, 4, 24)]


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("lq,lk,h,d", NAT_SHAPES)
def test_kernel_mh_nat_plain_version_matches_pallas_kernel(lq, lk, h, d, kind):
    arrays = _inputs(lq, lk, h, d)
    ref = _jax(jfa._flash_nat_packed, arrays, kind)
    _hold(_port(fa._plain_1block, arrays, kind, sum="fp32"), ref, kind)


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("lq,lk,h,d", XPK_SHAPES)
def test_kernel_cross_packed_plain_version_matches_pallas_kernel(lq, lk, h, d, kind):
    arrays = _inputs(lq, lk, h, d)
    ref = _jax(jfa._cross_packed, arrays, kind)
    _hold(_port(fa._plain_cross_packed, arrays, kind), ref, kind, nearly_exact=True)


def _xpk_variant(q, k, v, sm_scale, zero_shift, bf16_den):
    """``_plain_cross_packed`` with either of its two roundings left out."""
    s = fa._scores(q, k, sm_scale)
    m = s.amax(-1, keepdim=True)
    if zero_shift:
        m = m.clamp(min=0.0)
    pc = torch.exp2(s - m).to(v.dtype).float()
    l = pc.sum(-1, keepdim=True)
    if bf16_den:
        l = l.to(k.dtype).float()
    return ((pc @ v.float()) / l).to(q.dtype)


def test_cross_packed_zero_shift_is_needed():
    """All logits negative: the TPU kernel's padded kv columns (logit 0)
    set the shift; the row max alone moves many bf16 outputs."""
    q, k, v = _inputs(256, 77, 2, 40, seed=5)
    q, k = np.abs(q), -np.abs(k)  # every q.k < 0
    ref = _jax(jfa._cross_packed, (q, k, v), "bf16")
    good = _port(fa._plain_cross_packed, (q, k, v), "bf16")
    bad = _port(_xpk_variant, (q, k, v), "bf16", zero_shift=False, bf16_den=True)
    assert _mismatch(good, ref) < MISMATCH_TOL
    assert _mismatch(bad, ref) > 0.05


def test_cross_packed_bf16_denominator_is_needed():
    """The row sum is rounded to bf16 before it divides: without that
    rounding many outputs land one bf16 ulp off."""
    arrays = _inputs(256, 77, 4, 40, seed=6)
    ref = _jax(jfa._cross_packed, arrays, "bf16")
    bad = _port(_xpk_variant, arrays, "bf16", zero_shift=True, bf16_den=False)
    assert _mismatch(_port(fa._plain_cross_packed, arrays, "bf16"), ref) < MISMATCH_TOL
    assert _mismatch(bad, ref) > 0.05


@pytest.fixture
def cross_impl(monkeypatch):
    def set_impl(impl):
        monkeypatch.setattr(jfa, "_CROSS_IMPL", impl)
        monkeypatch.setattr(fa, "_CROSS_IMPL", impl)
    return set_impl


@pytest.mark.parametrize("lever,lq,lk,name", [
    ("native_long_kv", 512, 512, "_kernel_mh_nat"),
    ("nat", 256, 77, "_kernel_mh_nat"),
    ("xpk", 1024, 77, "_kernel_cross_packed"),
    ("xpk", 256, 256, "_kernel_mh_nat"),
])
def test_jvp_matches_jax(cross_impl, lever, lq, lk, name):
    """Tangents go through the plain (B, L, H, D) reference in both packages;
    fp32, 1e-4."""
    h = 2
    native = lever == "native_long_kv"
    if not native:
        cross_impl(lever)
    bq, bk = fa._blocks(lq, lk, None, None)
    assert fa._packed_kernel_name(lq, lk, h, bq, bk, native) == name
    primals, tangents = _inputs(lq, lk, h, 16, seed=2, b=1), _inputs(lq, lk, h, 16, seed=3, b=1)
    ref_o, ref_t = jax.jvp(lambda *a: jfa.flash_mha(*a, interpret=True, native_long_kv=native),
                           tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents)))
    got_o, got_t = torch.func.jvp(lambda *a: fa.flash_mha(*a, native_long_kv=native),
                                  tuple(map(t, primals)), tuple(map(t, tangents)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_and_cuda_is_required_to_launch(cross_impl):
    arrays = _inputs(1024, 77, 2, 40, seed=4, b=1)
    q, k, v = (a.transpose(1, 2) for a in _packed_views(arrays, "bf16"))
    before = dict(fa.flash_mha.launches)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    nat = fa.flash_mha(q, k, v, native_long_kv=True)
    assert torch.equal(nat, fa._plain_1block(qt, kt, vt, 40**-0.5, "fp32").transpose(1, 2))
    cross_impl("xpk")
    xpk = fa.flash_mha(q, k, v)
    assert torch.equal(xpk, fa._plain_cross_packed(qt, kt, vt, 40**-0.5).transpose(1, 2))
    assert fa.flash_mha.launches == before
    for name in ("_kernel_mh_nat", "_kernel_cross_packed"):
        with pytest.raises(ValueError, match="CUDA"):
            fa._launch_packed(q, k, v, 40**-0.5, name)


def test_transformer_block_under_xpk_matches_jax(monkeypatch, cross_impl):
    """``_CROSS_IMPL="xpk"`` in both packages, 4 heads at 2048 tokens
    (>= 4 * H * 128): the 77-token cross-attention reaches
    ``_kernel_cross_packed``, the self-attention the long-row kernel."""
    cross_impl("xpk")
    seen = []
    real = fa._plain_cross_packed

    def spy(*a):
        seen.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(fa, "_plain_cross_packed", spy)
    jblk = JaxTransformerBlock(32, 4, 16, dtype=jnp.float32, ffn_impl="einsum", attn_impl="flash")
    params = draw_params(jblk, jnp.zeros((1, 2048, 32)), jnp.zeros((1, 77, 16)), seed=4)
    blk = carry(TransformerBlock(32, 4, 16, dtype=torch.float32, attn_impl="flash"), params)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 2048, 32)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 16)).astype(np.float32)
    ref = np.asarray(jblk.apply({"params": params}, x, ctx))
    with torch.no_grad():
        got = blk(t(x), t(ctx)).numpy()
    assert seen == [(1, 4, 2048, 8)]
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-5)
