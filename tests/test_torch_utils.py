"""The port's profiling utilities (``utils/{traceparse,profiling}``): the
kernel-family taxonomy and the Chrome-trace parser on a small synthetic
torch.profiler trace (families and totals), ``profiling.trace`` writing a
trace on the CPU that the parser reads, the phase timer and memory stats.
The spans and counters: ``tests/test_torch_tracing.py``."""

import gzip
import json
import sys
from pathlib import Path

import pytest
import torch

from superdiff_tpu_torch.utils import profiling, traceparse

REPO = Path(__file__).resolve().parents[1]

FAMILY_CASES = {
    "void fused_sde_step_kernel<4>(Params)": "fused_sde_step",
    "void attn_sm90_online<40, 3>(AttnArgs)": traceparse.ONLINE,
    "void attn_sm90_two_pass<40, true, 2>(AttnArgs)": traceparse.EOD,
    "void attn_sm90_two_pass<80, false, 2>(AttnArgs)": traceparse.ATTN_OTHER,
    "void attn_sm90_short<40>(AttnArgs)": traceparse.ATTN_OTHER,
    "void geglu_up<__nv_bfloat16, false>(GemmArgs)": "geglu_ffn_block",
    "geglu_ln": "geglu_ffn_block",
    "void sd_or_step_kernel(Params)": "sd_or_step",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "convolution",
    "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN": "gemm",
    "ampere_sgemm_128x64_tn": "gemm",
    "void (anonymous namespace)::softmax_warp_forward<float, float, float, 8>": "softmax",
    "void at::native::reduce_kernel<512, 1>(ReduceOp)": "reduction",
    "void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>": (
        "elementwise / copy / cat"),
    "void at::native::CatArrayBatchedCopy<float, 4>(...)": "elementwise / copy / cat",
    "Memcpy HtoD (Pageable -> Device)": "other",
}


@pytest.mark.parametrize("name,want", sorted(FAMILY_CASES.items()))
def test_family_taxonomy(name, want):
    assert traceparse.family(name) == want
    assert traceparse.category(name) == want


def test_chip_smoke_reports_in_the_same_taxonomy():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert chip_smoke.family is traceparse.family
    assert (chip_smoke.ONLINE, chip_smoke.EOD) == (traceparse.ONLINE, traceparse.EOD)


def _trace(events):
    return {"schemaVersion": 1, "traceEvents": events}


EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "void attn_sm90_online<40, 3>(AttnArgs)", "dur": 1500},
    {"ph": "X", "cat": "kernel", "name": "void attn_sm90_online<40, 3>(AttnArgs)", "dur": 500},
    {"ph": "X", "cat": "kernel", "name": "geglu_up", "dur": 700},
    {"ph": "X", "cat": "kernel", "name": "geglu_down", "dur": 300},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "dur": 40},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 10},
    # host activity and device annotations mirror the kernels: not counted
    {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "dur": 99999},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 7777},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#1", "dur": 5555},
    {"ph": "i", "cat": "kernel", "name": "geglu_up", "dur": 12345},
]


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_load_and_categorize_a_synthetic_trace(tmp_path, gz, capsys):
    d = tmp_path / "run" / "plugins"
    d.mkdir(parents=True)
    if gz:
        with gzip.open(d / "x.pt.trace.json.gz", "wt") as fh:
            json.dump(_trace(EVENTS), fh)
    else:
        (d / "x.pt.trace.json").write_text(json.dumps(_trace(EVENTS)))
    per_op = traceparse.load_device_ops(str(tmp_path))
    assert per_op["void attn_sm90_online<40, 3>(AttnArgs)"] == 2000
    assert per_op["geglu_up"] == 700 and "aten::matmul" not in per_op
    cats, total = traceparse.categorize(per_op)
    assert total == 3050
    assert cats == {traceparse.ONLINE: 2000, "geglu_ffn_block": 1000, "other": 50}
    out = traceparse.report(per_op, iters=2)
    assert out["total_device_ms_per_iter"] == pytest.approx(1.525)
    assert out["categories_ms_per_iter"][traceparse.ONLINE] == pytest.approx(1.0)
    assert "total device time" in capsys.readouterr().out


def test_missing_trace_raises(tmp_path):
    with pytest.raises(AssertionError, match="no Chrome trace"):
        traceparse.load_device_ops(str(tmp_path))


@pytest.mark.parametrize("host", [True, False])
def test_profiling_trace_writes_a_trace_on_the_cpu(tmp_path, host):
    """Without a card the host is recorded either way."""
    with profiling.trace(str(tmp_path / "tb"), host=host) as prof:
        a = torch.randn(32, 32)
        (a @ a).sum()
    path = tmp_path / "tb" / profiling.TRACE_FILE
    data = json.loads(path.read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(e.key in ("aten::mm", "aten::matmul") for e in prof.key_averages())
    assert traceparse.load_device_ops(str(tmp_path / "tb")) == {}  # no card, no device events


def test_phase_timer_and_memory_stats(capsys):
    class Sink:
        def __init__(self):
            self.logged = []

        def log(self, **kw):
            self.logged.append(kw)

    sink = Sink()
    with profiling.phase_timer("work", sink) as t:
        x = t.sync(torch.ones(3) * 2)
    assert torch.equal(x, torch.full((3,), 2.0))
    assert sink.logged[0]["phase"] == "work" and sink.logged[0]["seconds"] == t.elapsed >= 0
    with profiling.phase_timer("printed"):
        pass
    assert "[profile] printed:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}

