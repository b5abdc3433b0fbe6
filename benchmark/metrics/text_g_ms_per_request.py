"""Device milliseconds of SDXL's second text tower (OpenCLIP ViT-bigG/14) a
request: the program's ``encode_g`` spans (between CUDA events at the
span's ends, so the card's idle time between eager launches counts),
summed over the traced requests and divided by them. Silent where the
program runs no such tower."""

from benchmark.harness.program_spans import ms_per_request


def read(run):
    return ms_per_request("encode_g")
