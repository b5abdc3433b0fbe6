"""Device milliseconds a sampler step takes: the CUDA-event spans the
driver records around the step loop of each request of the window (for
SD from the last prompt encoding to the decoder's start, for CIFAR around
the generator's call), summed and divided by the steps the window ran."""


def read(run):
    if not run.sampler_ms or not run.steps:
        return None
    return sum(run.sampler_ms) / run.steps
