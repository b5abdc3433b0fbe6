"""Device milliseconds of the prompt encoding a request: the program's
``encode`` spans (all three encodings, between CUDA events at the span's
ends, so the card's idle time between eager launches counts), summed over
the traced requests and divided by them. Silent where the program encodes
nothing (CIFAR)."""

from benchmark.harness.program_spans import ms_per_request


def read(run):
    return ms_per_request("encode")
