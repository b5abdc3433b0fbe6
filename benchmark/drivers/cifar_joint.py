"""Traffic of the CIFAR joint sampler: batches of samples drawn back to
back, each a whole reverse trajectory of the superposed score nets through
``superdiff_tpu_torch.pipelines.cifar.make_generator``, with the weights
and the noise the benchmark draws from the seed (the closed loop of an FID
job: 50 000 samples in batches).

Spans: ``inputs`` (the batch's noise), ``sample`` (the generator's call,
timed between CUDA events). The check runs the configuration's plain
reference over a sample of the window's batches and of their rows, drawn
from the seed, and compares x0 and the running log-densities.
"""

from __future__ import annotations

import torch

from benchmark.harness import compare
from benchmark.harness.driver import Driver as Base
from benchmark.harness.weights import generator
from benchmark.harness.yardstick import count_flops
from benchmark.reference._precision import precision


class Driver(Base):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        c = cell.config
        self.batch = cell.traffic["batch"]
        self.steps = c["sampler"]["n_steps"]
        self.shape = (self.batch, c["model"]["image_size"], c["model"]["image_size"],
                      c["model"]["num_channels"])
        self.samples_per_request = self.batch

    def build(self, state):
        from superdiff_tpu_torch.pipelines.cifar import CifarConfig, make_generator

        c, t = self.cell.config, self.cell.traffic
        m, s = c["model"], c["sampler"]
        self.ccfg = CifarConfig(
            nf=m["nf"], ch_mult=tuple(m["ch_mult"]), num_res_blocks=m["num_res_blocks"],
            attn_resolutions=tuple(m["attn_resolutions"]), dropout=m["dropout"],
            compute_dtype=m["compute_dtype"], image_size=m["image_size"],
            num_channels=m["num_channels"], eval_batch_size=self.batch,
            n_sample_steps=s["n_steps"], t_1=s["t_1"])
        nets = []
        for i in range(c["n_models"]):
            with torch.device(self.device):
                net = self.ccfg.model()
            net.load_state_dict(state[f"model_{i}"], strict=True)
            nets.append(net.eval().requires_grad_(False))
        self.nets = nets
        self.gen = make_generator(nets, self.ccfg, mode=t["mode"], operator=t["operator"])

    def inputs(self, i: int, rows=None):
        """Batch ``i``'s unit normals (x1, zs), its ``rows`` only where given."""
        g = generator(self.device, self.seed, 2, i)
        x1 = torch.randn(self.shape, generator=g, device=self.device)
        zs = torch.randn((self.steps,) + self.shape, generator=g, device=self.device)
        if rows is not None:
            x1, zs = x1[rows], zs[:, rows]
        return x1, zs

    def serve(self, i: int):
        self.phases.to("inputs")
        x1, zs = self.inputs(i)
        self.span_begin("sample")
        x0, logq = self.gen(noise=(x1, zs))
        self.span_end("sync")
        return {"x0": x0, "logq": logq}

    def release(self):
        self.gen = self.nets = None
        super().release()

    def reference_answers(self, ref, models, i: int, rows, mode: str):
        x1, zs = self.inputs(i, rows)
        with precision(mode):
            x0, logq, margin = ref.sample_or(models, self.cell.config, x1, zs)
        return {"x0": x0, "logq": logq, "margin": margin}

    def row_numbers(self, ref, models, i: int, rows, answers, truth):
        """Per row: x0's distance from the reference's over the distance the
        nets moved it, the log-densities' over theirs; rows whose OR choice
        the reference makes by less than ``check.or_margin`` (a tie within
        rounding) left out."""
        x1, zs = self.inputs(i, rows)
        moved = truth["x0"] - ref.noise_path(self.cell.config, x1, zs)
        lq = truth["logq"]
        kept = truth["margin"] >= self.cell.traffic["check"]["or_margin"]
        self.notes.append(f"request {i}: {int((~kept).sum())} of {len(rows)} rows left out, "
                          "their OR choice a tie within rounding in the reference")
        return {
            "x0": compare.row_gap(answers["x0"], truth["x0"], moved)[kept],
            "logq": compare.row_gap(answers["logq"], lq, lq.abs().clamp_min(1.0))[kept],
        }

    @staticmethod
    def pick(answers: dict, rows) -> dict:
        return {"x0": answers["x0"][rows], "logq": answers["logq"][rows]}

    def model_flops(self, ref) -> int:
        """FLOPs of one batch as the plain reference counts them: every
        model's forward a step."""
        c = self.cell.config
        m = ref.build(c, "meta")
        x = torch.empty(self.shape, device="meta")
        t = torch.zeros((self.batch,), device="meta")
        return self.steps * sum(count_flops(lambda net=net: net(t, x)) for net in m.values())

    def step_work(self) -> dict:
        return {"attention": [], "ffn": []}
