"""Device milliseconds a sampler step spends in the elementwise / copy /
cat family (the frozen kernel taxonomy), over the ops launched inside the
``sample`` spans of the traced window, divided by the steps."""

from benchmark.harness.tracing import GLUE


def read(run):
    r = run.reading
    if r is None or not run.steps:
        return None
    sec = r.family_seconds("sample").get(GLUE, 0.0)
    return 1e3 * sec / run.steps if sec > 0 else None
