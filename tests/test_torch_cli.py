"""The port's ``cifar`` and ``sd`` commands (``superdiff_tpu_torch/cli.py``)
against JAX's parsers, and a tiny run of each on the CPU.

Each subcommand takes JAX's arguments at JAX's defaults, plus ``--device``
(the card by default; JAX's top-level ``--platform``); the top level takes
JAX's multi-process flags. ``sd --preset tiny`` runs two steps and writes the
latents, the images, the config snapshot and the metrics file (the CLIP and
ImageReward scores are absent without local weights). ``cifar`` trains a
tiny config for a few steps (``CONFIGS`` swapped for it, as the full-width
nets are too slow for the CPU), then writes the dataset statistics of the
stand-in data with a stub feature extractor.
"""

import json
import os

import numpy as np
import pytest

from superdiff_tpu.cli import build_parser as jax_parser
from superdiff_tpu_torch import cli
from superdiff_tpu_torch.pipelines import cifar


def options(parser, cmd):
    sub = parser._subparsers._group_actions[0].choices[cmd]
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None) for a in sub._actions}


@pytest.mark.parametrize("cmd", ["cifar", "sd", "protein"])
def test_parser_takes_jax_arguments(cmd):
    jopts, opts = options(jax_parser(), cmd), options(cli.build_parser(), cmd)
    assert set(opts) - set(jopts) == {"device"} and set(jopts) <= set(opts)
    assert all(opts[k] == v for k, v in jopts.items()), {
        k: (opts[k], v) for k, v in jopts.items() if opts[k] != v}
    assert opts["device"][0] == "cuda"


def test_no_multi_process_flags():
    """Since the parallel tier was ported the top level takes JAX's three
    multi-process flags at JAX's defaults, and still no ``--platform``
    (``--device`` on each command stands for it)."""
    def top(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest not in ("help", "cmd")}

    flags = {"coordinator_address", "num_processes", "process_id"}
    assert set(top(cli.build_parser())) == flags
    assert top(cli.build_parser()) == {k: v for k, v in top(jax_parser()).items() if k in flags}
    assert "platform" in top(jax_parser())


def test_sd_tiny_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("SUPERDIFF_ALLOW_DOWNLOAD", raising=False)
    out = tmp_path / "sd"
    cli.main(["sd", "--device", "cpu", "--preset", "tiny", "--method", "or",
              "--num_inference_steps", "2", "--batch_size", "1", "--height", "64",
              "--width", "64", "--obj", "a cat", "--bg", "a dog", "--out_dir", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"final_ll_obj", "final_ll_bg"}
    img_dir = out / "or" / "a_cat_and_a_dog"
    with np.load(img_dir / "latents.npz") as f:
        assert f["latents"].shape == (1, 8, 8, 4) and np.isfinite(f["latents"]).all()
    assert (img_dir / "0.png").exists() or (img_dir / "images.npz").exists()
    metrics = json.loads((out / "metrics_or" / "metrics_or_a_cat_and_a_dog.json").read_text())
    assert "clip" not in metrics and len(metrics["final_ll_obj"]) == 1
    assert json.loads((out / "config_snapshot.json").read_text())["device"] == "cpu"


def test_cifar_train_and_fid_stats_on_the_cpu(tmp_path, monkeypatch, capsys):
    from superdiff_tpu_torch.eval import fid

    tiny = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                batch_size=8, log_every=1, save_every=2, eval_batch_size=8,
                compute_dtype="float32", image_size=16)
    monkeypatch.setitem(cifar.CONFIGS, "vpsde", lambda: cifar.CifarConfig(**tiny))
    monkeypatch.delenv("SUPERDIFF_DATA_DIR", raising=False)
    wd = tmp_path / "cifar"
    cli.main(["cifar", "--device", "cpu", "--mode", "train", "--config", "vpsde",
              "--n_iters", "2", "--batch_size", "4", "--workdir", str(wd)])
    assert sorted(os.listdir(wd / "checkpoints")) == ["chkpt_2.pt"]
    recs = [json.loads(line) for line in (wd / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(r["loss"]) for r in recs)
    assert json.loads((wd / "config_snapshot.json").read_text())["batch_size"] == 4

    monkeypatch.setattr(fid, "get_inception_feature_fn",
                        lambda *a, **k: lambda imgs: imgs.reshape(len(imgs), -1)[:, :6]
                        .astype(np.float32))
    cli.main(["cifar", "--device", "cpu", "--mode", "fid_stats", "--config", "vpsde",
              "--workdir", str(wd)])
    stats = capsys.readouterr().out.strip().splitlines()[-1]
    assert sorted(os.listdir(stats)) == ["cifar10_test_stats.npz", "cifar10_train_stats.npz"]
    with np.load(os.path.join(stats, "cifar10_test_stats.npz")) as f:
        assert f["pool_3"].shape[1] == 6
