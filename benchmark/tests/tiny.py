"""The cells cut to a size the CPU runs in seconds (every layer kind kept,
widths and steps cut, float32), and one run of such a cell past the look
for a card."""

from __future__ import annotations

import argparse
import time

import torch

from benchmark.harness import runner, spec


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a CPU size: every layer kind
    kept, widths and steps cut, float32."""
    cell = spec.find_cell(name)
    c = cell.config
    if "unet" in c:
        c["unet"].update(block_out_channels=[32, 64, 64, 64], cross_attention_dim=64,
                         attention_head_dim=4)
        c["text_encoder"].update(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                                 num_attention_heads=4)
        c["vae"].update(block_out_channels=[32, 64], layers_per_block=1)
        c["method"]["num_inference_steps"] = 4
        c["dtype"] = "float32"
        cell.traffic.update(height=64, width=64, batch=2)
        cell.traffic["check"]["rows"] = 2
    else:
        c["model"].update(nf=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16],
                          compute_dtype="float32")
        c["sampler"]["n_steps"] = 5
        cell.traffic.update(batch=4)
        cell.traffic["check"]["rows"] = 4
    return cell


def run_tiny(cell, seed: int = 2**31 + 7, seconds: float = 0.0, trace: int = 0):
    """One run of ``cell`` on the CPU past the look for a card: (result,
    the check's lines)."""
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
    return runner.execute(cell, args, torch.device("cpu"), time.perf_counter())


