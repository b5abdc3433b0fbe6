"""The yardstick's arithmetic: FLOPs counted with FlopCounterMode over the
plain references on the meta device, and the roofline of a kernel's work."""

import pytest

from benchmark.harness import spec, yardstick

TERA = 1e12


@pytest.fixture(scope="module")
def sd_counts():
    cell = spec.find_cell("sd-v1-4.or.512.b8")
    ref = cell.reference()
    import torch

    m = ref.build(cell.config, "meta")
    out = {}
    for b in (8, 1):
        lat = torch.empty((b, 64, 64, 4), device="meta")
        ctx = torch.empty((3 * b, 77, 768), device="meta")
        ids = torch.zeros((3 * b, 77), dtype=torch.long, device="meta")
        out[b] = {
            "unet": yardstick.count_flops(lambda: m["unet"](lat, torch.zeros((), device="meta"),
                                                            ctx)),
            "vae": yardstick.count_flops(lambda: m["vae"](lat)),
            "clip": yardstick.count_flops(lambda: m["text"](ids)),
        }
    return out


def test_sd_flops_per_step_and_request(sd_counts):
    # the UNet with the conditionings' latents shared up to the first
    # cross-attention, every upsample as four 2x2 phase convolutions
    assert sd_counts[8]["unet"] / TERA == pytest.approx(17.718, rel=1e-3)
    assert sd_counts[1]["unet"] / TERA == pytest.approx(2.2146, rel=1e-3)
    assert sd_counts[8]["clip"] / TERA == pytest.approx(0.3192, rel=1e-3)
    assert sd_counts[8]["vae"] / TERA == pytest.approx(17.024, rel=1e-3)
    assert sd_counts[8]["vae"] == pytest.approx(8 * sd_counts[1]["vae"], rel=1e-3)


def test_cifar_flops_per_batch():
    cell = spec.find_cell("cifar10-pair.or_sde.b100")
    d = cell.driver().Driver(cell, 1, "cpu")
    per_batch = d.model_flops(cell.reference())
    assert per_batch / (2 * 200) / TERA == pytest.approx(1.1274, rel=1e-3)


def test_roofline_arithmetic():
    fl, by = yardstick.attention_work(24, 8, 4096, 4096, 40)
    assert fl == 4 * 24 * 8 * 4096 * 4096 * 40
    assert by == 2 * 24 * 8 * 40 * 4 * 4096
    assert yardstick.least_seconds(fl, by) == pytest.approx(fl / 989e12)
    fl, by = yardstick.geglu_ffn_work(98304, 320, 1280)
    assert fl == 6 * 98304 * 320 * 1280
    assert by == 2 * (2 * 98304 * 320 + 3 * 320 * 1280)
    # bytes bound a thin product
    assert yardstick.least_seconds(1e6, 3.35e9) == pytest.approx(1e-3)
    with pytest.raises(KeyError):
        yardstick.peak("cpu")


def test_sd_step_work_matches_the_unets_layers():
    cell = spec.find_cell("sd-v1-4.or.512.b8")
    w = cell.driver().Driver(cell, 1, "cpu").step_work()
    assert len(w["attention"]) == 10 and len(w["ffn"]) == 16
    ms = 1e3 * yardstick.least_seconds_of(w["attention"])
    assert ms == pytest.approx(2.584, rel=1e-3)
    assert 1e3 * yardstick.least_seconds_of(w["ffn"]) == pytest.approx(3.725, rel=1e-3)
    # the first transformer's self-attention runs before the first
    # cross-attention, on the latent batch alone
    assert w["attention"][0][0] * 3 == w["attention"][1][0]
