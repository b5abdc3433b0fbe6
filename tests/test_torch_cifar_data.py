"""The port's data pipeline and small utilities against the JAX package's:
``ImageDataset`` batches bit for bit on the synthetic stand-in and on a tiny
``cifar-10-batches-py`` written to ``tmp_path``, the split DSL, the
prefetcher, the scalers, ``stack_imgs`` and the JSONL metric records."""

import json
import os
import pickle

import numpy as np
import pytest

from superdiff_tpu.data import datasets as jdata
from superdiff_tpu.utils import images as jimages
from superdiff_tpu.utils.logging import MetricLogger as JaxLogger
from superdiff_tpu_torch.data import datasets as data
from superdiff_tpu_torch.utils import images
from superdiff_tpu_torch.utils.logging import MetricLogger


def _batches(ds, n, bs, **kw):
    it = ds.batches(bs, **kw)
    return [next(it) for _ in range(n)]


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """The synthetic stand-in (no local files in the data dir given), one
    class-filtered split, in both packages."""
    empty = str(tmp_path_factory.mktemp("no_data"))
    port = data.ImageDataset("cifar10", "train>5", data_dir=empty, seed=3)
    ref = jdata.ImageDataset("cifar10", "train>5", data_dir=empty, seed=3)
    return port, ref


def test_synthetic_batches_equal_jax(synthetic):
    port, ref = synthetic
    assert port.synthetic and ref.synthetic
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert np.all(port.labels >= 5)
    _same_batches(_batches(port, 3, 16), _batches(ref, 3, 16))
    plain = dict(uniform_dequantization=False, random_flip=False, scale_to_pm1=False)
    _same_batches(_batches(port, 2, 10, **plain), _batches(ref, 2, 10, **plain))


def _write_cifar10(root, n_per_batch=20, seed=0):
    """The cifar-10-batches-py layout: pickled dicts, b'data' (N, 3072)
    uint8 planes R, G, B and b'labels' lists."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        x = rng.integers(0, 256, size=(n_per_batch, 3072), dtype=np.uint8)
        y = rng.integers(0, 10, size=n_per_batch).tolist()
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": x, b"labels": y}, f)


@pytest.mark.parametrize("split", ["train", "test", "train[:50%]", "train[50%:]", "train<5"])
def test_local_cifar10_batches_equal_jax(tmp_path, split):
    _write_cifar10(str(tmp_path))
    port = data.ImageDataset("cifar10", split, data_dir=str(tmp_path), seed=1)
    ref = jdata.ImageDataset("cifar10", split, data_dir=str(tmp_path), seed=1)
    assert not port.synthetic
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    n = 3 * len(port) // 4
    _same_batches(_batches(port, 3, n), _batches(ref, 3, n))
    finite = dict(loop=False, random_flip=False)
    _same_batches(list(port.batches(7, **finite)), list(ref.batches(7, **finite)))


def test_data_dir_from_the_environment(tmp_path, monkeypatch):
    _write_cifar10(str(tmp_path))
    monkeypatch.setenv("SUPERDIFF_DATA_DIR", str(tmp_path))
    assert not data.ImageDataset("cifar10", "test").synthetic


@pytest.mark.parametrize("split", ["train", "test", "train[:50%]", "train[25%:75%]",
                                   "train[50%:]", "train<5", "train>5", "test<3"])
def test_split_dsl_equals_jax(split):
    spec, ref = data.SplitSpec.parse(split), jdata.SplitSpec.parse(split)
    assert spec.__dict__ == ref.__dict__
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((40, 2)), rng.integers(0, 10, 40)
    for a, b in zip(spec.apply(x, y), ref.apply(x, y)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        data.SplitSpec.parse("train[:50%")


def test_prefetch_iterator_and_scalers():
    it = data.PrefetchIterator(iter(range(5)))
    assert list(it) == [0, 1, 2, 3, 4]

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = data.PrefetchIterator(endless(), depth=2)
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    it.close()
    assert not it._thread.is_alive()
    x = np.linspace(0, 1, 7, dtype=np.float32)
    for centered in (True, False):
        np.testing.assert_array_equal(data.get_image_scaler(centered)(x),
                                      jdata.get_image_scaler(centered)(x))
        np.testing.assert_array_equal(data.get_image_inverse_scaler(centered)(x),
                                      jdata.get_image_inverse_scaler(centered)(x))


def test_stack_imgs_and_metric_records(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (10, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(images.stack_imgs(x, 3, 3), jimages.stack_imgs(x, 3, 3))
    u8 = (x * 255).astype(np.uint8)
    np.testing.assert_array_equal(images.stack_imgs(u8, 2, 4), jimages.stack_imgs(u8, 2, 4))
    recs = []
    for cls, name in ((MetricLogger, "port"), (JaxLogger, "jax")):
        path = tmp_path / name / "metrics.jsonl"
        log = cls(str(path))
        log.log(step=5, loss=1.5, steps_per_sec=2.0)
        log.log(bpd=3.25)
        recs.append([json.loads(line) for line in path.read_text().splitlines()])
    for a, b in zip(*recs):
        assert a.pop("ts") > 0 and b.pop("ts") > 0
        assert a == b
