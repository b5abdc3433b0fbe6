"""The share of the traced window's wall time in which no kernel, copy or
memset ran on the card, in percent (from the profiler's device trace)."""


def read(run):
    r = run.reading
    if r is None or r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
