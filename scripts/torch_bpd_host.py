#!/usr/bin/env python3
"""The port's dopri5 bits/dim on the CPU for the tiny ScoreUNet of
``tests/test_torch_cifar_bpd.py::test_score_unet_dopri5_matches_jax_controller``
(rtol = atol = 1e-2, t_0 = 1e-2, two torch threads, as the test): the
value, the count of evaluations and the host's CPU, to measure how far the
value moves between hosts; torch only, so it runs where JAX is absent.

    python3 tests/bpd_inputs.py build/bpd_inputs.npz   # with JAX: the test's inputs
    python3 scripts/torch_bpd_host.py build/bpd_inputs.npz
"""

import argparse
import platform
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from superdiff_tpu_torch.core.schedules import VPSchedule  # noqa: E402
from superdiff_tpu_torch.eval import bpd  # noqa: E402
from superdiff_tpu_torch.pipelines import cifar  # noqa: E402

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16)


def main(path):
    torch.set_num_threads(2)
    with np.load(path) as f:
        sd = {k[len("param:"):]: torch.from_numpy(f[k]) for k in f.files if k.startswith("param:")}
        x0, probe = torch.from_numpy(f["x0"]), torch.from_numpy(f["probe"])
    net = cifar.CifarConfig(**TINY).model()
    net.load_state_dict(sd)
    net.eval().requires_grad_(False)
    got, nfe = bpd.make_bpd_estimator(lambda t, x: net(t.expand(2, 1, 1, 1), x), VPSchedule(),
                                      method="dopri5", rtol=1e-2, atol=1e-2, t_0=1e-2)(
        x0, probe=probe)
    lines = open("/proc/cpuinfo").read().splitlines()
    cpu = next((ln.split(":", 1)[1].strip() for ln in lines if ln.startswith("model name")),
               platform.processor())
    flags = next((ln.split(":", 1)[1].split() for ln in lines if ln.startswith("flags")), [])
    isa = [f for f in ("avx2", "avx512f", "avx512_bf16", "amx_tile") if f in flags]
    print(f"port dopri5 bpd {got.item():.6f}, {nfe} evaluations; torch {torch.__version__}, "
          f"CPU {cpu} ({' '.join(isa)})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("inputs", help="the .npz that tests/bpd_inputs.py wrote")
    main(ap.parse_args().inputs)
