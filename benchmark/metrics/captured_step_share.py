"""The share of the traced requests' sampler steps that replayed a captured
CUDA graph, in percent: the program's ``steps_replayed`` over
``steps_replayed`` + ``steps_eager``. A capturing request's step 0 counts
under neither (it is the ``capture`` span, counted in ``graphs_captured``);
a loop that no longer fits its request and falls back to eager steps lowers
it."""

from benchmark.harness.program_spans import recording


def read(run):
    rec = recording()
    if rec is None:
        return None
    replayed = rec.totals.get("steps_replayed", 0)
    steps = replayed + rec.totals.get("steps_eager", 0)
    return 100.0 * replayed / steps if steps else None
