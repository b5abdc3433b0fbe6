"""The port's InceptionV3 and FID / IS math against the JAX package's, fp32
on the CPU.

Weights cross as the JAX package writes them: random weights drawn with
numpy in ``init_params``' shapes, saved by JAX's ``save_npz`` and read by the
port's ``load_npz``. Two 32x32 uint8 images go through the JAX ``apply``
(jitted) and the port's module: pool3 features and logits within 1e-4 of
their largest magnitude (94 convolutions summed in other orders by XLA and
PyTorch). The 32 -> 299 bilinear resize alone within 1e-5 of the range,
borders included. The FID / IS / bootstrap numbers are the same numpy and
scipy math: within 1e-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superdiff_tpu.eval import fid as jfid
from superdiff_tpu.models import inception as jinception
from superdiff_tpu_torch.eval import fid
from superdiff_tpu_torch.models import inception

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A JAX-layout .npz of random weights: He-scaled normal kernels, 0.1 N
    biases (as BatchNorm folding leaves them), a logits head."""
    shapes = jax.eval_shape(jinception.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = {}
    for name, leaves in shapes.items():
        k = leaves["kernel"].shape
        fan_in = int(np.prod(k[:-1]))
        params[name] = {
            "kernel": (rng.standard_normal(k) * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32),
        }
    path = str(tmp_path_factory.mktemp("inception") / "inception.npz")
    jinception.save_npz(params, path)
    return path


def test_npz_layout_crosses(weights):
    params = inception.load_npz(weights)
    ref = jinception.load_npz(weights)
    assert params.keys() == ref.keys() and len(params) == inception.num_convs() + 1
    model = inception.build(params, device="cpu")
    assert len(model.convs) == 94
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["convs.5.weight"].numpy(),
                                  np.asarray(ref["conv5"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["predictions.weight"].numpy(),
                                  np.asarray(ref["predictions"]["kernel"]).T)


def test_resize_matches_jax_bilinear():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(299, 299),
                        mode="bilinear", align_corners=False, antialias=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy() / 255, ref / 255, rtol=0,
                               atol=1e-5)


def test_pool_features_and_logits_match_jax(weights):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    jparams = jinception.load_npz(weights)
    ref = jax.jit(lambda p, x: jinception.apply(p, x))(jparams, jnp.asarray(imgs))
    pool, logits = inception.make_feature_fn(inception.load_npz(weights), with_logits=True,
                                             device="cpu")(imgs)
    for got, want in ((pool, ref["pool"]), (logits, ref["logits"])):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == np.float32
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)
    fn = fid.get_inception_feature_fn(weights, device="cpu")
    np.testing.assert_array_equal(fn(imgs), pool)
    np.testing.assert_array_equal(
        fid.get_inception_logits_fn(weights, device="cpu")(imgs, batch_size=128), logits)


def test_extractors_need_a_weights_file():
    assert fid.get_inception_feature_fn(None) is None
    assert fid.get_inception_feature_fn("imagenet") is None
    assert fid.get_inception_logits_fn(None) is None


def _write_legacy_h5(path, rng, n):
    import h5py

    with h5py.File(path, "w") as f:
        for i in range(n):
            g = f.create_group(f"conv2d_{i + 1}").create_group(f"conv2d_{i + 1}")
            g.create_dataset("kernel:0", data=rng.standard_normal((1, 1, 2, 3)))
            g = f.create_group(f"batch_normalization_{i + 1}").create_group(
                f"batch_normalization_{i + 1}")
            g.create_dataset("beta:0", data=rng.standard_normal(3))
            g.create_dataset("moving_mean:0", data=rng.standard_normal(3))
            g.create_dataset("moving_variance:0", data=rng.uniform(0.5, 2, 3))
        g = f.create_group("predictions").create_group("predictions")
        g.create_dataset("kernel:0", data=rng.standard_normal((3, 4)))
        g.create_dataset("bias:0", data=rng.standard_normal(4))


def _write_keras3_h5(path, rng, n):
    import h5py

    with h5py.File(path, "w") as f:
        layers = f.create_group("layers")
        for i in range(n):
            suffix = "" if i == 0 else f"_{i}"
            layers.create_group(f"conv2d{suffix}").create_group("vars").create_dataset(
                "0", data=rng.standard_normal((1, 1, 2, 3)))
            bv = layers.create_group(f"batch_normalization{suffix}").create_group("vars")
            bv.create_dataset("0", data=rng.standard_normal(3))
            bv.create_dataset("1", data=rng.standard_normal(3))
            bv.create_dataset("2", data=rng.uniform(0.5, 2, 3))
        dv = layers.create_group("dense").create_group("vars")
        dv.create_dataset("0", data=rng.standard_normal((3, 4)))
        dv.create_dataset("1", data=rng.standard_normal(4))


@pytest.mark.parametrize("writer", [_write_legacy_h5, _write_keras3_h5])
def test_keras_h5_conversion_equals_jax(tmp_path, writer):
    """The copied h5 converters (BatchNorm folding, layer order) on small
    stand-in arrays in each Keras layout; a wrong layer count raises."""
    path = str(tmp_path / "w.h5")
    writer(path, np.random.default_rng(3), 94)
    got, ref = inception.load_params(path), jinception.load_params(path)
    assert got.keys() == ref.keys()
    for name in ref:
        for leaf in ref[name]:
            np.testing.assert_allclose(got[name][leaf], np.asarray(ref[name][leaf]),
                                       rtol=1e-6)
    bad = str(tmp_path / "bad.h5")
    writer(bad, np.random.default_rng(3), 93)
    with pytest.raises(ValueError, match="layer counts"):
        inception.load_params(bad)


def test_fid_is_and_bootstrap_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    ref_feats = rng.standard_normal((300, 8))
    gen = rng.standard_normal((200, 8)) * 1.3 + 0.4
    np.testing.assert_allclose(fid.fid_from_features(ref_feats, gen),
                               jfid.fid_from_features(ref_feats, gen), rtol=1e-9)
    assert fid.fid_from_features(ref_feats, ref_feats) == pytest.approx(0.0, abs=1e-6)
    mu1, c1 = fid.feature_statistics(ref_feats)
    mu2, c2 = fid.feature_statistics(gen)
    np.testing.assert_allclose(fid.frechet_distance(mu1, c1, mu2, c2),
                               jfid.frechet_distance(mu1, c1, mu2, c2), rtol=1e-9)
    got, want = fid.fid_bootstrap(ref_feats, gen, n_boot=6, seed=2), jfid.fid_bootstrap(
        ref_feats, gen, n_boot=6, seed=2)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got["value"], got["boot_mean"], got["boot_std"], *got["ci95"]],
                               [want["value"], want["boot_mean"], want["boot_std"],
                                *want["ci95"]], rtol=1e-9)
    logits = rng.standard_normal((100, 10)) * 3
    np.testing.assert_allclose(fid.inception_score(logits, splits=5),
                               jfid.inception_score(logits, splits=5), rtol=1e-9)
    path = str(tmp_path / "stats.npz")
    np.savez_compressed(path, pool_3=ref_feats)
    np.testing.assert_array_equal(fid.load_dataset_stats(path), jfid.load_dataset_stats(path))
