"""The most device memory the window's tensors held at once, in GiB:
``torch.cuda.max_memory_allocated`` after a reset at the window's start."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2**30
