"""Model FLOPs utilisation of the whole request, in percent: the FLOPs of
the window's completed requests, as ``torch.utils.flop_counter`` counts
them over the plain reference on the ``meta`` device (products and
convolutions; the conditionings' shared latents once), over the window's
time, over the card's bf16 dense peak."""

from benchmark.harness.yardstick import peak


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    flops = run.flops_per_request() * run.requests
    return 100.0 * flops / run.window_s / peak(run.kind)["bf16_flops"]
