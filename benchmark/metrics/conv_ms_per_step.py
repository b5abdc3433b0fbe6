"""Device milliseconds a sampler step spends in the convolution family
(the frozen kernel taxonomy), over the ops launched inside the ``sample``
spans of the traced window, divided by the steps."""


def read(run):
    r = run.reading
    if r is None or not run.steps:
        return None
    sec = r.family_seconds("sample").get("convolution", 0.0)
    return 1e3 * sec / run.steps if sec > 0 else None
