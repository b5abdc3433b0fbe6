"""Traffic of the paper's AND composition on SD-1.x: as ``sd_compose``
(requests of one prompt pair each, served back to back by
``superdiff_tpu_torch.pipelines.sd.generate``) under the traffic's method
(``and``: the SDE with the closed-form kappa) and ``lift``.

The check runs the plain AND sampler (``reference/sd-and.py``) on the
configuration's reference modules and compares the latents, the
log-likelihood traces and the images on every sampled row: AND's kappa is
no choice between the two prompts, so no row is a tie to leave out.
"""

from __future__ import annotations

import os

import torch

from benchmark.drivers.sd_compose import Driver as SDDriver
from benchmark.harness import compare, spec
from benchmark.reference._precision import precision


def and_sampler():
    """The plain AND sampler's module, ``reference/sd-and.py``."""
    return spec.load_module(os.path.join(spec.HERE, "reference", "sd-and.py"),
                            "benchmark.reference.sd_and")


class Driver(SDDriver):
    def build(self, state):
        super().build(state)
        self.pcfg.lift = float(self.cell.traffic["lift"])

    def reference_answers(self, ref, models, i: int, rows, mode: str):
        """The plain AND sampler's answers to request ``i`` on ``rows``,
        computed in ``mode``, in the program's layout."""
        c, t = self.cell.config, self.cell.traffic
        obj, bg, x_T, zs = self.inputs(i, rows)
        method = dict(c["method"], lift=t["lift"])
        with precision(mode):
            lat, _, ll = and_sampler().sample_and(ref, models, c, obj, bg, x_T, zs, method)
            img = ref.decode(models["vae"], lat, c["vae"]["scaling_factor"])
        return {"latents": lat, "ll": ll, "images": img.to(torch.uint8)}

    def row_numbers(self, ref, models, i: int, rows, answers, truth):
        """Per row: the latents' distance from the reference's over the
        distance the networks moved them, the log-likelihood traces' over
        theirs, and the images' mean distance in levels from the reference's
        decode of the same latents."""
        c = self.cell.config
        _, _, x_T, zs = self.inputs(i, rows)
        lat = answers["latents"].float()
        with precision("fp32"):
            img_ref = ref.decode(models["vae"], lat, c["vae"]["scaling_factor"])
        moved = truth["latents"] - ref.noise_path(x_T, zs)
        ll_p, ll_r = (a.transpose(0, 1).reshape(len(rows), -1) for a in (answers["ll"],
                                                                          truth["ll"]))
        img_gap = (answers["images"].float() - img_ref).abs().reshape(len(rows), -1).mean(1)
        return {
            "latents": compare.row_gap(lat, truth["latents"], moved),
            "ll": compare.row_gap(ll_p, ll_r, ll_r - 1.0),
            "images": img_gap.double(),
        }
