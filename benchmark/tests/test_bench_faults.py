"""The check's controls, at a CPU size: a run whose timed path is broken
underneath comes out not correct, once for each fault the cells can have
(a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced), and so does the plain reference
computed in the precision below the configuration's, put in the
program's place. The cells run on one card, so no exchange between cards
can be left out."""

import pytest
import torch

import superdiff_tpu_torch.core.superpose as superpose
import superdiff_tpu_torch.pipelines.sd as sd
from benchmark.tests.tiny import run_tiny, tiny_cell

SD, CIFAR = "sd-v1-4.or.512.b8", "cifar10-pair.or_sde.b100"


def _sd_step(fault):
    real = sd.sd_or_step

    def step(v_obj, v_bg, v_unc, x, eps, ll, sigma, dsigma, **kw):
        new_x, new_ll, kappa = real(v_obj, v_bg, v_unc, x, eps, ll, sigma, dsigma, **kw)
        if fault == "unchanged":
            return x.clone(), ll.clone(), kappa
        half = x.shape[0] // 2
        new_x, new_ll = new_x.clone(), new_ll.clone()
        new_x[half:], new_ll[half:] = x[half:], ll[half:]
        return new_x, new_ll, kappa

    return step


def _cifar_step(fault):
    real = superpose.fused_sde_step

    def step(sscores, x, eps, logq, *args, **kw):
        new_x, new_logq = real(sscores, x, eps, logq, *args, **kw)
        if fault == "unchanged":
            return x.clone(), logq.clone()
        half = x.shape[0] // 2
        new_x, new_logq = new_x.clone(), new_logq.clone()
        new_x[half:], new_logq[half:] = x[half:], logq[half:]
        return new_x, new_logq

    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_sd_broken_step_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(sd, "sd_or_step", _sd_step(fault))
    result, _ = run_tiny(tiny_cell(SD))
    assert result["correct"] is False and result["failed"] >= 1


def test_sd_altered_image_is_not_correct(monkeypatch):
    real = sd.decode_to_uint8

    def decode(vae, latents, scaling):
        img = real(vae, latents, scaling)
        img[-1] = 255 - img[-1]
        return img

    monkeypatch.setattr(sd, "decode_to_uint8", decode)
    result, _ = run_tiny(tiny_cell(SD))
    assert result["correct"] is False


def test_sd_altered_latent_row_is_not_correct(monkeypatch):
    real = sd.superdiff_sd_sample

    def sample(*args, **kw):
        lat, traces = real(*args, **kw)
        lat[-1] = lat[-1] * 1.05
        return lat, traces

    monkeypatch.setattr(sd, "superdiff_sd_sample", sample)
    result, _ = run_tiny(tiny_cell(SD))
    assert result["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_cifar_broken_step_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(superpose, "fused_sde_step", _cifar_step(fault))
    result, _ = run_tiny(tiny_cell(CIFAR))
    assert result["correct"] is False and result["failed"] >= 1


def test_cifar_altered_sample_is_not_correct(monkeypatch):
    real = superpose.SuperposeSampler._sde_or

    def sde_or(self, *args, **kw):
        x, logq = real(self, *args, **kw)
        x[-1] = x[-1] * 1.05
        return x, logq

    monkeypatch.setattr(superpose.SuperposeSampler, "_sde_or", sde_or)
    result, _ = run_tiny(tiny_cell(CIFAR))
    assert result["correct"] is False


@pytest.mark.parametrize("name", [SD, CIFAR])
def test_the_program_itself_is_correct(name):
    result, _ = run_tiny(tiny_cell(name))
    assert result["correct"] is True


@pytest.mark.parametrize("name", [SD, CIFAR])
def test_the_control_is_not_correct(name):
    from benchmark.harness import compare

    cell = tiny_cell(name)
    drv = cell.driver().Driver(cell, 2**31 + 7, "cpu")
    drv.setup()
    drv.request(0)
    numbers, _ = drv.check([0], control="fp8")
    assert not compare.verdict(numbers, cell.traffic["limits"])[0], numbers
