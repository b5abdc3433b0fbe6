"""The port CLI's ``--coordinator_address / --num_processes /
--process_id`` (``superdiff_tpu_torch/cli.py``, JAX ``cli.py:439-449``):
two gloo processes each run ``cifar --mode train`` of a tiny config
(``CONFIGS`` swapped) with the flags, join one process group through
``parallel.distributed.initialize`` and train data-parallel; only rank 0
writes the metrics and the checkpoints, and both ranks end with the same
parameters, bit for bit."""

import json

import torch
from torch_dist import run_world

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16, batch_size=4, log_every=1, save_every=2)


def test_cli_multi_process_train(tmp_path):
    outs = run_world(2, {"cli_train": {"cfg": TINY, "workdir": str(tmp_path), "n_iters": 2}},
                     env={"TORCH_DIST_NO_INIT": "1"})
    a, b = outs[0]["cli_train"], outs[1]["cli_train"]
    assert (a["rank"], a["world"], b["rank"], b["world"]) == (0, 2, 1, 2)
    assert a["step"] == b["step"] == 3
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    assert a["checkpoints"] == b["checkpoints"] == ["chkpt_2.pt"]
    metrics = (tmp_path / "shared" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(m)["step"] for m in metrics] == [1, 2]
