"""The port's FLD (``eval/fld.py``) against the JAX package's, fp32 on the
CPU: the pairwise squared distances (rtol 1e-5), the Adam-fitted
log-variances, ``fld`` and ``fld_repeated`` (rtol 1e-4: the same 200 Adam
steps, the port's written out as optax computes them), and JAX's own three
behaviours (``tests/test_eval.py``): a matching distribution scores lower
than a shifted one, and a memorized one is penalized.

A memorized centre sits on a train copy, so its squared distance is the
rounding residue of ``|x|^2 - 2 x.c + |c|^2`` (0 or a few ulps of |x|^2,
differently in each framework's GEMM), and that residue sets the
bandwidth floor. Its fit is therefore held to JAX's on JAX's distances
(``d2=``), and its FLD by JAX's ordering alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.eval import fld as jfld
from superdiff_tpu_torch.eval import fld

torch.set_num_threads(2)

CPU = dict(device="cpu")


def _feats(seed, n, d, shift=0.0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, d)) + shift).astype(np.float32)


def test_pairwise_d2_matches_jax():
    x, c = _feats(0, 300, 16, scale=3.0), _feats(1, 120, 16, shift=0.5)
    ref = np.asarray(jfld._pairwise_d2(jnp.asarray(x), jnp.asarray(c), chunk=128))
    got = fld._pairwise_d2(x, c, chunk=128, **CPU).numpy()
    assert got.shape == (300, 120)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("memorized", [False, True], ids=["fresh", "memorized"])
def test_fitted_log_variances_match_jax(memorized):
    train = _feats(2, 400, 8)
    gen = train[:100].copy() if memorized else _feats(3, 100, 8, shift=0.3)
    kw = {}
    if memorized:
        kw["d2"] = jfld._pairwise_d2(jnp.asarray(train), jnp.asarray(gen))
    ref = jfld.fit_mog_bandwidths(gen, train, n_steps=200, **kw)
    if memorized:
        kw["d2"] = torch.from_numpy(np.array(kw["d2"]))
    got = fld.fit_mog_bandwidths(gen, train, n_steps=200, **kw, **CPU)
    assert got.dtype == np.float32 and got.shape == (100,)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_fld_and_repeated_match_jax():
    train, test = _feats(4, 500, 12), _feats(5, 300, 12)
    gen = _feats(6, 160, 12, shift=0.2, scale=1.1)
    np.testing.assert_allclose(fld.fld(gen, train, test, **CPU),
                               jfld.fld(gen, train, test), rtol=1e-4)
    ref = jfld.fld_repeated(gen, train, test, n_repeats=3, subsample=80, seed=7)
    got = fld.fld_repeated(gen, train, test, n_repeats=3, subsample=80, seed=7, **CPU)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)


def test_fld_prefers_matching_distribution():
    """JAX's ``test_fld_prefers_matching_distribution`` on the port: lower
    for generated features matching train / test than for a shifted set, and
    a memorized (train-copy) set is no better than the matching one."""
    rng = np.random.default_rng(0)
    d = 8
    train = rng.normal(size=(400, d))
    test = rng.normal(size=(400, d))
    good_gen = rng.normal(size=(200, d))
    shifted_gen = rng.normal(size=(200, d)) + 3.0
    f_good = fld.fld(good_gen, train, test, n_steps=60, **CPU)
    f_bad = fld.fld(shifted_gen, train, test, n_steps=60, **CPU)
    assert f_good < f_bad, (f_good, f_bad)
    f_mem = fld.fld(train[:200].copy(), train, test, n_steps=60, **CPU)
    assert f_good <= f_mem + 0.05, (f_good, f_mem)
    np.testing.assert_allclose([f_good, f_bad],
                               [jfld.fld(a, train, test, n_steps=60)
                                for a in (good_gen, shifted_gen)], rtol=1e-4)


def test_tensor_features_and_the_optional_extras():
    train, test, gen = _feats(8, 200, 6), _feats(9, 100, 6), _feats(10, 50, 6)
    as_np = fld.fld(gen, train, test, n_steps=20, **CPU)
    as_t = fld.fld(*(torch.from_numpy(a) for a in (gen, train, test)), n_steps=20, **CPU)
    assert as_np == as_t
    assert fld.fld_bridge_constant(gen, train, test, **CPU) is None  # no fld package here
    assert fld.get_dinov2_feature_fn(device="cpu") is None  # no local DINOv2 weights here
