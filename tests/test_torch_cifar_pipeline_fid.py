"""The port's ``evaluate_joint_fid`` / ``evaluate_fid`` end to end on the
CPU at the JAX pipeline test's tiny config, with stub features: they write
the files the JAX package writes (names, keys, dtypes and shapes). Split
from ``test_torch_cifar_pipeline_train.py``, whose helpers it uses, so that
each file stays under a minute."""

import dataclasses
import json
import os

import numpy as np
import torch
from test_torch_cifar_pipeline_train import TINY, stub_features

from superdiff_tpu.pipelines import cifar as jcifar
from superdiff_tpu_torch.pipelines import cifar

torch.set_num_threads(2)


def _tree(root):
    """{relative path: {npz key: (dtype, shape)} or the JSON keys}."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npz"):
                with np.load(path) as f:
                    out[rel] = {k: (f[k].dtype, f[k].shape) for k in f.files}
            elif name.endswith(".json"):
                with open(path) as f:
                    out[rel] = sorted(json.load(f))
    return out


def test_evaluate_joint_fid_writes_jax_files(tmp_path):
    cfg = cifar.CifarConfig(**{**TINY, "num_samples": 16})
    wd_a, wd_b = str(tmp_path / "a"), str(tmp_path / "b")
    cifar.train(cfg, wd_a, n_iters=3, device="cpu")
    cifar.train(dataclasses.replace(cfg, seed=2), wd_b, n_iters=3, device="cpu")
    ref_feats = np.random.default_rng(0).normal(size=(256, 6)).astype(np.float32)
    stats_path = str(tmp_path / "stats.npz")
    np.savez_compressed(stats_path, pool_3=ref_feats)
    out = str(tmp_path / "out")
    report = cifar.evaluate_joint_fid(cfg, out, [wd_a, wd_b], stoch=True,
                                      stats_path=stats_path, feature_fn=stub_features,
                                      device="cpu")
    assert set(report) == {"fid"} and np.isfinite(report["fid"])
    # the JAX entry point over two fresh (unsaved) runs, for the files it writes
    jcfg = jcifar.CifarConfig(**{**TINY, "num_samples": 16})
    jout = str(tmp_path / "jax_out")
    jcifar.evaluate_joint_fid(jcfg, jout, [str(tmp_path / "ja"), str(tmp_path / "jb")],
                              stoch=True, stats_path=stats_path, feature_fn=stub_features)
    files = _tree(out)
    assert files == _tree(jout)
    assert files["eval/samples_stoch/samples_0.npz"] == {"samples": (np.uint8, (8, 16, 16, 3))}
    single = cifar.evaluate_fid(cfg, wd_a, stoch=True, stats_path=stats_path,
                                feature_fn=stub_features, device="cpu")
    assert np.isfinite(single["fid"])
    assert len(os.listdir(os.path.join(wd_a, "eval", "samples_stoch"))) == 2
