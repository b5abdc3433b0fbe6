"""The port's spans and counters (``utils/profiling.py``): nothing recorded
while recording is off; the span tree of a served SD request and of a CIFAR
batch with their counters; host times on the kineto trace's clock and no
profiler range of their own; the switch that a profiler session turns on and
off. On the card (``python3 -m pytest tests/test_torch_tracing.py -m chip
--noconftest``, where no JAX is installed): the captured run's counters and
device times, and no event inside a capture."""

import collections

import numpy as np
import pytest
import torch
from torch.autograd import profiler as ap

from superdiff_tpu_torch.core import superpose as sp
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig
from superdiff_tpu_torch.models.sd.unet import SDUNetConfig
from superdiff_tpu_torch.models.sd.vae import VAEConfig
from superdiff_tpu_torch.pipelines import cifar, sd
from superdiff_tpu_torch.utils import profiling

STEPS, HW, BATCH = 3, 64, 2
TINY_CIFAR = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                  compute_dtype="float32", image_size=16, eval_batch_size=2)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _sd_stack():
    return sd.build_sd_modules(0, unet_config=SDUNetConfig.tiny(),
                               text_config=CLIPTextConfig.tiny(), vae_config=VAEConfig.tiny(),
                               device="cpu", dtype=torch.float32)


def _sd_noise(seed):
    g = torch.Generator().manual_seed(seed)
    shape = (BATCH, HW // 8, HW // 8, 4)
    return torch.randn(shape, generator=g), torch.randn((STEPS,) + shape, generator=g)


def _tree(rec):
    """{span id: span}, and the names of each span's children in order."""
    by_id = {s.id: s for s in rec.spans}
    kids = collections.defaultdict(list)
    for s in rec.spans:
        if s.parent is not None:
            kids[s.parent].append(s.name)
    return by_id, kids


def _one(rec, name):
    found = [s for s in rec.spans if s.name == name]
    assert len(found) == 1, (name, [s.name for s in rec.spans])
    return found[0]


def test_off_records_nothing():
    profiling.clear()
    assert not ap._is_profiler_enabled
    assert profiling.span("request") is profiling.span("step")  # one shared no-op
    with profiling.span("request"):
        profiling.count("steps_eager", 3)
    assert list(profiling.steps(range(2), "steps_eager")) == [0, 1]
    assert profiling.records().spans == [] and not profiling.records().totals


def test_sd_request_tree():
    mod = _sd_stack()
    cfg = sd.SDPipelineConfig(num_inference_steps=STEPS, height=HW, width=HW)
    with profiling.record() as rec:
        out = sd.generate(mod, "or", "a cat", "a dog", batch_size=BATCH, cfg=cfg,
                          noise=_sd_noise(1), capture=False)
    assert out["images"].dtype == torch.uint8
    by_id, kids = _tree(rec)
    request = _one(rec, "request")
    assert request.parent is None and all(s.request == request.id for s in rec.spans)
    assert kids[request.id] == ["encode", "sample", "decode"]
    sample, steps = _one(rec, "sample"), _one(rec, "steps")
    assert kids[sample.id] == ["steps"] and kids[steps.id] == ["step"] * STEPS
    assert kids[_one(rec, "encode").id] == [] and kids[_one(rec, "decode").id] == []
    assert steps.counts == {"steps_eager": STEPS} and sample.counts == {"loops_built": 1}
    assert rec.totals == {"steps_eager": STEPS, "loops_built": 1}
    for s in rec.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        assert s.device_ms() is None  # no card
        if s.parent is not None:
            outer = by_id[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


@pytest.mark.parametrize("method", ["and", "sd_ab"])
def test_sd_eager_methods_have_steps(method):
    mod = _sd_stack()
    cfg = sd.SDPipelineConfig(num_inference_steps=STEPS, height=HW, width=HW)
    ctxs = sd.prepare_contexts(mod, method, "a cat", "a dog", BATCH)
    with profiling.record() as rec:
        sd.superdiff_sd_sample(mod, method, *ctxs, cfg, noise=_sd_noise(2))
    _, kids = _tree(rec)
    assert kids[_one(rec, "sample").id] == ["steps"]
    assert kids[_one(rec, "steps").id] == ["step"] * STEPS
    assert rec.totals == {"steps_eager": STEPS}


def _cifar_generator(mode="sde", operator="or"):
    cfg = cifar.CifarConfig(**TINY_CIFAR)
    models = cifar.build_cifar_models([0, 1], cfg, "cpu")
    return cifar.make_generator(models, cfg, mode=mode, operator=operator, n_steps=STEPS)


def test_cifar_request_tree():
    gen = _cifar_generator()
    g = torch.Generator().manual_seed(3)
    with profiling.record() as rec:
        x0, logq = gen(generator=g)
    assert x0.shape == (2, 16, 16, 3) and logq.shape == (2, 2)
    _, kids = _tree(rec)
    request = _one(rec, "request")
    assert all(s.request == request.id for s in rec.spans)
    assert kids[request.id] == ["sample"]
    assert kids[_one(rec, "sample").id] == ["load", "steps"]
    assert kids[_one(rec, "steps").id] == ["step"] * STEPS
    assert rec.totals == {"steps_eager": STEPS, "loops_built": 1}
    assert not any(s.name in ("encode", "decode") for s in rec.spans)


def test_cifar_eager_modes_have_steps():
    gen = _cifar_generator(operator="avg")
    with profiling.record() as rec:
        gen(generator=torch.Generator().manual_seed(4))
    _, kids = _tree(rec)
    assert kids[_one(rec, "sample").id] == ["steps"]
    assert rec.totals == {"steps_eager": STEPS}


def test_kept_loop_counts_replays_and_loads(monkeypatch):
    """A captured CIFAR run with a stand-in for the graph (capture itself
    needs the card): the first run builds the loop and replays all but step
    0; the second loads its inputs into the kept loop and replays every
    step."""
    from superdiff_tpu_torch.core import capture

    class StandIn:
        def __init__(self, step):
            self.replay = step

    def capture_step(step):
        step()
        return StandIn(step)

    monkeypatch.setattr(capture, "capture_step", capture_step)
    monkeypatch.setattr(sp, "want_capture", lambda c, dev, what: True)
    gen = _cifar_generator()
    seen = []
    for seed in (5, 6):
        with profiling.record() as rec:
            gen(generator=torch.Generator().manual_seed(seed))
        seen.append((dict(rec.totals), [s.name for s in rec.spans if s.name == "load"]))
    assert seen[0] == ({"loops_built": 1, "steps_replayed": STEPS - 1}, ["load"])
    assert seen[1] == ({"steps_replayed": STEPS}, ["load", "load"])


def test_spans_share_the_kineto_clock_and_emit_no_range():
    """A span around ``torch.mm`` holds the trace's ``aten::mm`` event
    within 1 ms on each side; the trace holds no event of the span's own."""
    a = torch.randn(64, 64)
    torch.mm(a, a)
    profiling.clear()
    with ap.profile(use_kineto=True) as prof:
        with profiling.span("superdiff.mm"):
            torch.mm(a, a)
    s = _one(profiling.records(), "superdiff.mm")
    events = list(prof.kineto_results.events())
    mm = [e for e in events if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert s.start_ns <= start <= s.start_ns + 1_000_000
    assert end <= s.end_ns <= end + 1_000_000
    assert not [e.name() for e in events if "superdiff" in e.name()]
    profiling.clear()


@pytest.mark.parametrize("session", ["autograd", "trace"])
def test_a_profiler_session_switches_recording(tmp_path, session):
    """On inside a torch profiler session, and off once it stops, as the
    benchmark's session stops (``_disable_profiler``, then
    ``_run_on_profiler_stop``) or ``profiling.trace`` closes."""
    profiling.clear()
    if session == "autograd":
        prof = ap.profile(use_kineto=True)
        prof.__enter__()
        with profiling.span("inside"):
            profiling.count("n")
        ap._disable_profiler()
        ap._run_on_profiler_stop()
    else:
        with profiling.trace(str(tmp_path / "tb")):
            with profiling.span("inside"):
                profiling.count("n")
    assert not ap._is_profiler_enabled
    with profiling.span("after"):
        profiling.count("n")
    rec = profiling.records()
    assert [s.name for s in rec.spans] == ["inside"] and rec.totals == {"n": 1}
    assert rec.spans[0].counts == {"n": 1}
    profiling.clear()
    assert profiling.records().spans == []


def test_phase_timer_is_a_span_and_blocks_nest():
    with profiling.record() as outer:
        with profiling.phase_timer("work"):
            with profiling.record() as inner:
                profiling.count("n", 2)
    assert [s.name for s in outer.spans] == ["work"] and outer.spans[0].counts == {"n": 2}
    assert inner.spans == [] and inner.totals == {"n": 2} and outer.totals == {"n": 2}


def test_steps_close_on_an_early_exit():
    with profiling.record() as rec:
        with profiling.span("sample"):
            with pytest.raises(RuntimeError):
                for i in profiling.steps(range(5), "steps_eager"):
                    if i == 2:
                        raise RuntimeError("stop")
            with profiling.span("next"):
                pass
    by_id, _ = _tree(rec)
    assert by_id[_one(rec, "next").parent].name == "sample"
    assert rec.totals == {"steps_eager": 2}
    assert all(s.end_ns is not None for s in rec.spans)


# -- on the card ----------------------------------------------------------------

@pytest.mark.chip
def test_captured_runs_count_and_time_on_the_card(card):
    """The first captured CIFAR ``or`` run at a tiny ScoreUNet builds the
    loop, captures once and replays the other steps; a second of the same
    shapes loads its inputs into the kept loop and replays every step.
    Every span outside the capture has its device time; one opened inside a
    capture records no event."""
    cfg = cifar.CifarConfig(**TINY_CIFAR)
    models = cifar.build_cifar_models([0, 1], cfg, card)
    gen = cifar.make_generator(models, cfg, n_steps=STEPS)
    totals = []
    for seed in (1, 2):
        with profiling.record() as rec:
            gen(generator=torch.Generator(device=card).manual_seed(seed))
        torch.cuda.synchronize()
        totals.append(dict(rec.totals))
        for s in rec.spans:
            assert s.device_ms() is not None and s.device_ms() >= 0, s.name
    assert totals[0] == {"loops_built": 1, "graphs_captured": 1, "steps_replayed": STEPS - 1}
    assert totals[1] == {"steps_replayed": STEPS}
    assert [s.name for s in rec.spans].count("load") == 2

    x = torch.zeros(8, device=card)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with profiling.record() as rec:
        with torch.cuda.stream(side):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph, stream=side):
            with profiling.span("inside"):
                x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    inside = _one(rec, "inside")
    assert inside.events is None and inside.device_ms() is None and inside.end_ns is not None
    assert np.isclose(x[0].item(), 2.0)
