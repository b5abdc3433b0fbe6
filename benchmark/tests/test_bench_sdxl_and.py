"""The SDXL cell and the AND traffic at a CPU size, float32 on both sides:
the plain references (``reference/sdxl-base-1.0.py``,
``reference/sd-and.py``) against the program agree to rounding, the program
reads ``correct``, and the controls do not: the pooled embedding zeroed in
the program's SDXL request, and the reference in fp8 in the program's
place.

The AND traffic (``traffic/and.512.b8.json``, driver ``sd_and``) has no
entry in BENCHMARK.json: its eager step's runs spread more than half the
``samples_per_s`` bound (PERF.md), so the entry it would have is given
here (``AND_ENTRY``).

The SDXL cut keeps every layer kind of the configuration (three levels,
none with attention at the first, transformer depth (1, 1, 2), both
towers, the added embedding, zeros for the empty prompt) at 1/10 of the
widths, 64 px and 4 steps. At that size the random nets' two OR
likelihoods run close (margins 0.003-0.008 of the increments), and the
check would leave every row out as a possible tie; with float32 on both
sides nothing turns a tie, so the cut compares every row (``or_margin``
0).
"""

from unittest import mock

import pytest
import torch

import superdiff_tpu_torch.pipelines.sd as sd
from benchmark.harness import compare, spec
from benchmark.tests.tiny import run_tiny, tiny_cell

XL, AND = "sdxl-base-1.0.or.1024.b4", "sd-v1-4.and.512.b8"
SEED = 2**31 + 11


def tiny_sdxl_cell():
    cell = spec.find_cell(XL)
    c = cell.config
    c["unet"].update(block_out_channels=[32, 64, 64], attention_head_dim=[2, 4, 4],
                     transformer_layers_per_block=[1, 1, 2], cross_attention_dim=64,
                     addition_time_embed_dim=8, projection_class_embeddings_input_dim=32 + 6 * 8)
    for key in ("text_encoder", "text_encoder_2"):
        c[key].update(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, projection_dim=32)
    c["vae"].update(block_out_channels=[32, 64], layers_per_block=1)
    c["method"].update(num_inference_steps=4, size_ids=[64, 64, 0, 0, 64, 64])
    c["dtype"] = "float32"
    cell.traffic.update(height=64, width=64, batch=2)
    cell.traffic["check"].update(rows=2, or_margin=0.0)
    return cell


AND_ENTRY = {"name": AND, "config": "sd-v1-4", "traffic": "and.512.b8", "chips": 1,
             "why": "SDE AND of one prompt pair at 512 px, latent batch 8, 50 eager steps"}


def tiny_and_cell():
    """``tiny.py``'s CPU cut of the AND traffic, its cell entry given."""
    bench = spec.load_json(f"{spec.ROOT}/BENCHMARK.json")
    bench["workloads"].append(AND_ENTRY)
    find = spec.find_cell
    with mock.patch.object(spec, "find_cell", lambda name: find(name, bench=bench)):
        return tiny_cell(AND)


CELLS = {XL: tiny_sdxl_cell, AND: tiny_and_cell}


@pytest.mark.parametrize("name,tol", [
    (XL, {"latents": 1e-4, "ll": 1e-4, "images": 1.0}),
    (AND, {"latents": 1e-4, "ll": 1e-4, "images": 1.0}),
])
def test_reference_against_the_program(name, tol):
    cell = CELLS[name]()
    drv = cell.driver().Driver(cell, SEED, "cpu")
    drv.setup()
    drv.request(0)
    drv.release()
    numbers, _ = drv.check([0])
    assert set(numbers) == set(tol)
    for k, v in numbers.items():
        assert v <= tol[k], (k, v)


@pytest.mark.parametrize("name", [XL, AND])
def test_the_program_itself_is_correct(name):
    result, _ = run_tiny(CELLS[name]())
    assert result["correct"] is True, result["checks"]


def test_sdxl_pooled_embedding_zeroed_is_not_correct(monkeypatch):
    real = sd.encode_prompts_xl

    def encode(mod, prompts):
        ctx, pooled = real(mod, prompts)
        return ctx, torch.zeros_like(pooled)

    monkeypatch.setattr(sd, "encode_prompts_xl", encode)
    result, _ = run_tiny(tiny_sdxl_cell())
    assert result["correct"] is False and result["failed"] >= 1, result["checks"]


@pytest.mark.parametrize("name", [XL, AND])
def test_the_control_is_not_correct(name):
    cell = CELLS[name]()
    drv = cell.driver().Driver(cell, SEED, "cpu")
    drv.setup()
    drv.request(0)
    numbers, _ = drv.check([0], control="fp8")
    assert not compare.verdict(numbers, cell.traffic["limits"])[0], numbers


def test_sdxl_step_work_counts_every_block():
    """The yardstick's shapes at the published sizes: 70 FFN sub-blocks at
    the three conditionings' rows, and the 70 self-attentions over 4096 and
    1024 tokens at head dim 64."""
    cell = spec.find_cell(XL)
    drv = cell.driver().Driver(cell, SEED, "cpu")
    work = drv.step_work()
    assert len(work["ffn"]) == len(work["attention"]) == 70
    attn_flops = sum(f for f, _ in work["attention"])
    assert attn_flops == 10 * 4 * 12 * 10 * 4096**2 * 64 + 60 * 4 * 12 * 20 * 1024**2 * 64
