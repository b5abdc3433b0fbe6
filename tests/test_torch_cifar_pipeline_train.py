"""The port's CIFAR entry points end to end on the CPU at the JAX pipeline test's
tiny config (``tests/test_cifar_pipeline.py``): train and resume with the
JAX loop's step counts and records, the training-time sample grid and
bits/dim, and ``fid_stats`` with stub features writing the files the JAX
package writes (its statistics equal to JAX's on the same stub, bit for
bit). ``evaluate_joint_fid`` / ``evaluate_fid``:
``test_torch_cifar_pipeline_fid.py`` (its JAX side initialises two
training states op by op, about half a minute, so it has a file of its own
and each file stays under a minute)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from superdiff_tpu.pipelines import cifar as jcifar
from superdiff_tpu_torch.pipelines import cifar

torch.set_num_threads(2)

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            batch_size=16, log_every=5, save_every=10, n_iters=10,
            eval_batch_size=8, n_sample_steps=4, compute_dtype="float32", image_size=16)


def stub_features(imgs):
    """The JAX test's cheap deterministic embedding of uint8 images."""
    x = imgs.astype(np.float32) / 255.0
    return np.stack(
        [x.mean((1, 2, 3)), x[:, :8].mean((1, 2, 3)), x[:, 8:].mean((1, 2, 3)),
         x[..., 0].mean((1, 2)), x[..., 1].mean((1, 2)), x[..., 2].mean((1, 2))], axis=-1)


def _records(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_and_resume(tmp_path):
    cfg = cifar.CifarConfig(**TINY)
    wd = str(tmp_path / "run")
    state = cifar.train(cfg, wd, n_iters=10, device="cpu")
    assert state.step == 11
    assert sorted(os.listdir(os.path.join(wd, "checkpoints"))) == ["chkpt_10.pt"]
    recs = _records(wd)
    assert [r["step"] for r in recs] == [5, 10]
    assert all(set(r) == {"ts", "step", "loss", "steps_per_sec"} and np.isfinite(r["loss"])
               for r in recs)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    # preemption resume: a fresh call restores from the saved checkpoint
    state2 = cifar.train(cfg, wd, n_iters=12, device="cpu")
    assert state2.step == 13  # resumed at 11, ran 2 more
    assert not all(torch.equal(state2.params[n], before[n]) for n in before)
    assert cifar.train(cfg, wd, n_iters=12, device="cpu").step == 13  # checkpoint 10 again


def test_train_sample_grid_and_bpd(tmp_path):
    cfg = cifar.CifarConfig(**{**TINY, "eval_every": 2, "save_every": 100, "batch_size": 4,
                               "n_train_sample_steps": 3})
    wd = str(tmp_path / "run")
    cifar.train(cfg, wd, n_iters=2, eval_artifacts=True, estimate_bpd=True, device="cpu")
    with np.load(os.path.join(wd, "artifacts_2.npz")) as f:
        assert f["grid"].shape == (32, 32, 3) and f["grid"].dtype == np.uint8
    recs = _records(wd)
    assert {"nfe": 3, "artifact": "artifacts_2.npz"}.items() <= recs[0].items()
    assert np.isfinite(recs[1]["bpd"])


def test_fid_stats_equal_jax(tmp_path, monkeypatch):
    """The dataset statistics of both packages, each with the stub as its
    Inception extractor, on a tiny local CIFAR-10."""
    from superdiff_tpu.eval import fid as jfid
    from superdiff_tpu_torch.eval import fid
    from test_torch_cifar_data import _write_cifar10

    _write_cifar10(str(tmp_path / "data"), n_per_batch=12)
    monkeypatch.setenv("SUPERDIFF_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(fid, "get_inception_feature_fn", lambda *a, **k: stub_features)
    monkeypatch.setattr(jfid, "get_inception_feature_fn", lambda *a, **k: stub_features)
    cfg = cifar.CifarConfig(**{**TINY, "image_size": 32})
    out = cifar.fid_stats(cfg, str(tmp_path / "port"), inception_weights="w.npz", device="cpu")
    jout = jcifar.fid_stats(jcifar.CifarConfig(**{**TINY, "image_size": 32}),
                            str(tmp_path / "jax"), inception_weights="w.npz")
    for split, n in (("train", 56), ("test", 8)):
        name = f"cifar10_{split}_stats.npz"
        with np.load(os.path.join(out, name)) as a, np.load(os.path.join(jout, name)) as b:
            assert a.files == b.files == ["pool_3"] and a["pool_3"].shape == (n, 6)
            np.testing.assert_array_equal(a["pool_3"], b["pool_3"])
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="Inception"):
        cifar.fid_stats(cfg, str(tmp_path / "none"), device="cpu")


def test_configs_match_jax():
    assert set(cifar.CONFIGS) == set(jcifar.CONFIGS)
    for name in cifar.CONFIGS:
        port, ref = dataclasses.asdict(cifar.CONFIGS[name]()), dataclasses.asdict(
            jcifar.CONFIGS[name]())
        assert port == ref, name
