"""The long self-attention layers' share of their roofline, in percent:
the least time their work needs on the card (4 B H Lq Lk D FLOPs against
the bf16 peak, or q, k, v and o once against HBM, whichever is longer;
from the cell's shapes) over the device time of the kernels whose name
says attention, inside the ``sample`` spans. Silent where no such kernel
ran."""

from benchmark.harness.yardstick import least_seconds_of

PATTERN = r"attn|attention|flash|fmha|mha"


def read(run):
    r = run.reading
    work = run.driver.step_work()["attention"]
    if r is None or not work or not run.steps:
        return None
    sec = r.matching_seconds(PATTERN, "sample")
    if sec <= 0:
        return None
    return 100.0 * run.steps * least_seconds_of(work, run.kind) / sec
