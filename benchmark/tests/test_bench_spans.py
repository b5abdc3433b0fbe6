"""The SD driver's sampler span, whatever number of text-encoder calls the
program makes for a request: one a prompt, one batched call, or none
(contexts kept from an earlier request); and a clear failure where the
program's decoder no longer closes it."""

import pytest
import torch

import superdiff_tpu_torch.pipelines.sd as sd
from benchmark.tests.tiny import tiny_cell

SD = "sd-v1-4.or.512.b8"
SEED = 2**31 + 7


def _one_call(mod, method, obj, bg, batch_size):
    return sd.encode_prompts(mod, [obj] * batch_size + [bg] * batch_size
                             + [""] * batch_size).chunk(3)


def _kept():
    real, kept = sd.prepare_contexts, {}

    def prepare(mod, method, obj, bg, batch_size):
        if batch_size not in kept:
            kept[batch_size] = real(mod, method, obj, bg, batch_size)
        return kept[batch_size]

    return prepare


@pytest.mark.parametrize("encoding,calls", [("per_prompt", 3), ("one_call", 1), ("none", 0)])
def test_sd_sampler_span_whatever_the_encoder_calls(monkeypatch, encoding, calls):
    if encoding == "one_call":
        monkeypatch.setattr(sd, "prepare_contexts", _one_call)
    elif encoding == "none":
        monkeypatch.setattr(sd, "prepare_contexts", _kept())
    cell = tiny_cell(SD)
    drv = cell.driver().Driver(cell, SEED, "cpu")
    drv.setup()
    seen = []
    drv.mod.text.register_forward_hook(lambda *_: seen.append(1))
    drv.request(0)
    assert len(seen) == calls
    assert len(drv.sampler_ms) == 1
    assert 0 < drv.sampler_ms[0] < 1e3 * drv.request_s[0]


def test_sd_request_the_decoder_does_not_close_fails_clearly(monkeypatch):
    monkeypatch.setattr(sd, "decode_to_uint8",
                        lambda vae, latents, scaling: torch.zeros(latents.shape[:1],
                                                                  dtype=torch.uint8))
    cell = tiny_cell(SD)
    drv = cell.driver().Driver(cell, SEED, "cpu")
    with pytest.raises(RuntimeError, match="sampler span"):
        drv.setup()
