"""One sampler step captured in a CUDA graph and replayed, the port's
counterpart of the JAX package's compiled ``lax.scan`` over the steps.

A capturable step reads everything that changes from step to step through
a device step index: its scalars from a per-step table built on the host
before the loop and uploaded once, its noise from a (steps, ...) tensor
drawn before the loop; it writes its state and trace rows into static
buffers and advances the index. Eager, the sampler calls the same step once
per step; captured, the first run calls step 0 eagerly (which also warms
the libraries up), records one step in a CUDA graph and replays it for the
other steps, and every later run replays every step, with no launch outside
the graph.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import profiling


def want_capture(capture: Optional[bool], device: torch.device, what: str) -> bool:
    """Resolve a sampler's ``capture`` argument: ``None`` means captured on
    the card and eager on the CPU; ``True`` on CPU tensors raises."""
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"{what}: capture=True needs CUDA tensors, got {device}")
    return bool(capture)


def capture_step(step: Callable[[], None]) -> torch.cuda.CUDAGraph:
    """Run ``step`` once eagerly on a side stream (the sampler's first step:
    the kernel libraries load, cuBLAS and cuDNN pick their algorithms, the
    tensor maps are encoded), then record one ``step`` in a CUDA graph on
    that stream (recorded, not run) and return it. ``torch.cuda.graph``
    empties the allocator's cache before it records, dropped graphs' pools
    included: a capture cannot make the allocator free cached memory when
    it runs short. A failed capture raises; nothing falls back to eager.
    Both are the ``capture`` span, counted under ``graphs_captured``."""
    with profiling.span("capture"):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            step()
        profiling.count("graphs_captured")
    return graph


class StepLoop:
    """A sampler loop on static buffers. A subclass defines ``reset()``
    (the state back to the start, the step index to 0) and ``step()`` (one
    step, the step index advanced on the card); :meth:`advance` runs them."""

    graph = None

    def advance(self, steps: int, capture: bool) -> None:
        """Every step from the start: eagerly, or as replays of one captured
        step; the first captured run takes step 0 eagerly and captures the
        step after it. The loop after the capture is the ``steps`` span,
        each replay or eager step a ``step`` span, counted under
        ``steps_replayed`` or ``steps_eager``."""
        self.reset()
        done = 0
        if capture and self.graph is None and steps:
            self.graph = capture_step(self.step)
            done = 1
        counter = "steps_replayed" if capture else "steps_eager"
        for _ in profiling.steps(range(done, steps), counter):
            if capture:
                self.graph.replay()
            else:
                self.step()
