"""Device milliseconds a sampler step takes inside the program: the device
time of the program's ``steps`` spans (each request's loop of captured
replays or eager steps, the capture left out) summed over the traced
requests, divided by the steps they ran (their ``steps_replayed`` and
``steps_eager`` counts)."""

from benchmark.harness.program_spans import recording


def read(run):
    rec = recording()
    if rec is None:
        return None
    ms = steps = 0
    for s in rec.spans:
        n = s.counts.get("steps_replayed", 0) + s.counts.get("steps_eager", 0)
        d = s.device_ms() if s.name == "steps" and n else None
        if d is not None:
            ms, steps = ms + d, steps + n
    return ms / steps if steps else None
