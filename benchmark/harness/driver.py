"""What every driver shares: the weights drawn and loaded, the warm-up, the
request loop's spans and sampler clock, the answers kept for the check,
and the check itself against the configuration's plain reference.

A driver module (``drivers/<name>.py``) defines ``Driver``, a subclass that
gives ``build(state)`` (the program's modules from the drawn weights),
``serve(i)`` (request ``i`` through the program's entry; its answers),
``inputs``, ``reference_answers``, ``row_numbers`` and ``pick`` (the check),
``model_flops`` and ``step_work`` (the yardstick), and sets
``samples_per_request`` and ``steps``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import tracing, weights

WARMUP = 1 << 40  # the warm-up request's index: inputs of their own


class Driver:
    samples_per_request = 1
    steps = 1

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.phases = tracing.Phases()
        self.answers: dict = {}
        self.sampler_ms: list = []
        self.request_s: list = []  # host seconds of each request, sync included
        self._marks: list = []
        self.notes: list = []  # what the check says beside its numbers

    # ------------------------------------------------------------ set-up
    def draw(self, ref) -> dict:
        return weights.draw(ref.build(self.cell.config, "meta"), ref.served_dtype, self.seed,
                            self.device)

    def setup(self) -> None:
        """Weights drawn and loaded, then one request of the cell's shape
        (captures the step, lets the libraries choose their algorithms)."""
        state = self.draw(self.cell.reference())
        self.build(state)
        del state
        self.request(WARMUP)
        self.answers.clear()
        self.sampler_ms.clear()
        self.request_s.clear()

    # ----------------------------------------------------------- requests
    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def span_begin(self, phase: str) -> None:
        """The sampler's span starts here; the trace's phase turns to ``phase``."""
        self._marks = [self._mark()]
        self.phases.to(phase)

    def span_end(self, phase: str) -> None:
        """The sampler's span ends here, if it is open (a second end, as of a
        decoder called in parts, leaves it as it is); the trace's phase turns
        to ``phase``."""
        if len(self._marks) == 1:
            self._marks.append(self._mark())
        self.phases.to(phase)

    def request(self, i: int) -> int:
        """Serve request ``i`` whole, up to a device sync on its answers;
        returns the samples it completed."""
        t0 = time.perf_counter()
        self._marks = []
        answers = self.serve(i)
        self.phases.to("sync")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases.end()
        if len(self._marks) != 2:
            raise RuntimeError(f"request {i} recorded {len(self._marks)} of the sampler span's "
                               "two marks (span_begin, then span_end): the driver's hooks no "
                               "longer bracket the program's step loop")
        a, b = self._marks
        ms = a.elapsed_time(b) if self.device.type == "cuda" else (b - a) * 1e3
        self.answers[i] = answers
        self.sampler_ms.append(ms)
        self.request_s.append(time.perf_counter() - t0)
        return self.samples_per_request

    def release(self) -> None:
        """Drop the program's state (its modules, captured graphs and
        caches); the answers stay."""
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def reference_models(self, ref) -> dict:
        """The reference's modules on the device, float32, from the weights
        drawn again from the seed."""
        state = self.draw(ref)
        models = ref.build(self.cell.config, "meta")
        for part, mod in models.items():
            mod.load_state_dict({k: v.float() for k, v in state[part].items()}, assign=True)
            mod.eval().requires_grad_(False)
            state[part] = None
        return models

    def rows(self, i: int) -> list:
        """The rows of request ``i`` the check compares, drawn from the seed."""
        n = self.cell.traffic["check"]["rows"]
        rng = np.random.default_rng(weights.subseed(self.seed, 4, i))
        b = self.samples_per_request
        return sorted(int(r) for r in rng.choice(b, size=min(n, b), replace=False))

    def request_order(self) -> list:
        """The window's requests in the order the check takes them, drawn
        from the seed."""
        ids = sorted(self.answers)
        rng = np.random.default_rng(weights.subseed(self.seed, 5))
        return [int(i) for i in rng.permutation(ids)]

    def check(self, ids=None, control: str = "", limits=None):
        """(the compared numbers, each the worst over the compared rows; how
        many checked requests failed one of ``limits``): the program's
        answers, or with ``control`` (a precision of
        ``reference/_precision.py``) the reference's own answers computed in
        it, in the program's place. Requests are taken in
        :meth:`request_order` (or ``ids``) until ``check.requests`` of them
        and ``check.kept_rows`` rows that every number compares are done. A
        number with no row to compare is NaN, which fails."""
        want = self.cell.traffic["check"]
        ref = self.cell.reference()
        models = self.reference_models(ref)
        rows_of, failed, done, kept = {}, 0, 0, 0
        for i in (self.request_order() if ids is None else ids):
            if ids is None and done >= want["requests"] and kept >= want["kept_rows"]:
                break
            rows = self.rows(i)
            truth = self.reference_answers(ref, models, i, rows, "fp32")
            judged = (self.reference_answers(ref, models, i, rows, control) if control
                      else self.pick(self.answers[i], rows))
            per_row = self.row_numbers(ref, models, i, rows, judged, truth)
            worst = {k: v.max().item() for k, v in per_row.items() if v.numel()}
            if limits is not None and any(v != v or v > limits.get(k, float("-inf"))
                                          for k, v in worst.items()):
                failed += 1
            for k, v in per_row.items():
                rows_of.setdefault(k, []).append(v)
            done += 1
            kept += min(v.numel() for v in per_row.values())
            self.last_rows = {k: v.tolist() for k, v in per_row.items()}
            self.last_truth = truth
        return {k: torch.cat(v).max().item() if sum(x.numel() for x in v) else float("nan")
                for k, v in rows_of.items()}, failed
