"""Device milliseconds of the VAE decode to uint8 a request: the program's
``decode`` spans, summed over the traced requests and divided by them.
Silent where the program decodes nothing (CIFAR)."""

from benchmark.harness.program_spans import ms_per_request


def read(run):
    return ms_per_request("decode")
