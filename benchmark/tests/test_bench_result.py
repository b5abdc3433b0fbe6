"""A run's last line: its five keys, the compared numbers beside their
limits last, and no device number from a CPU run; the per-layer readers
on a traced window."""

import json

import pytest

from benchmark.harness import compare, runner, tracing
from benchmark.tests.tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["sd-v1-4.or.512.b8", "cifar10-pair.or_sde.b100"])
def test_last_line_keys(name):
    cell = tiny_cell(name)
    result, lines = run_tiny(cell)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["metrics"] == {}  # a CPU run reports no device numbers
    assert set(line["checks"]) == set(cell.traffic["limits"])
    for k, v in line["checks"].items():
        assert v["value"] <= v["limit"], k
    checks = [ln for ln in lines if ln.startswith("check ")]
    assert lines[-len(checks):] == checks and len(checks) == len(cell.traffic["limits"])
    assert all(" limit " in ln for ln in checks)


def test_verdict_fails_a_missing_or_non_finite_number():
    assert compare.verdict({"a": 1.0}, {"a": 2.0})[0]
    assert not compare.verdict({"a": 3.0}, {"a": 2.0})[0]
    assert not compare.verdict({"a": float("nan")}, {"a": 2.0})[0]
    assert not compare.verdict({}, {"a": 2.0})[0]
    assert not compare.verdict({"a": 1.0, "b": 1.0}, {"a": 2.0})[0]


def _fake_run(cell, reading, steps=100):
    drv = cell.driver().Driver(cell, 1, "cpu")
    run = runner.Run(cell, drv, cell.reference(), reading, window_s=10.0,
                     requests=steps // drv.steps, peak_window_bytes=3 * 2**30,
                     kind="NVIDIA H100 80GB HBM3")
    run.sampler_ms = [50.0] * run.requests
    return run


def test_readers_on_a_traced_window():
    cell = tiny_cell("sd-v1-4.or.512.b8")
    cell.traffic.update(height=512, width=512, batch=8)
    seconds = {("sample", "attn_sm90_two_pass<40, true, 0>"): 0.004,
               ("sample", "geglu_up<bf16>"): 0.002,
               ("sample", "vectorized_elementwise_kernel"): 0.001,
               ("decode", "cudnn_conv_fprop"): 0.002}
    reading = tracing.Reading(seconds=seconds, window=(0, 10_000_000), busy_s=0.009,
                              gaps=[("decode: aten::conv2d", 0.001)])
    run = _fake_run(cell, reading, steps=4)
    read = lambda m: cell.reader(m).read(run)  # noqa: E731
    assert read("device_idle_share") == pytest.approx(10.0)
    assert read("glue_ms_per_step") == pytest.approx(1.0 / 4)
    assert read("conv_ms_per_step") is None  # the decode's convolution is not the sampler's
    steps = run.steps
    w = run.driver.step_work()
    from benchmark.harness.yardstick import least_seconds_of

    assert read("attn_roofline") == pytest.approx(
        100 * steps * least_seconds_of(w["attention"]) / 0.004)
    assert read("ffn_roofline") == pytest.approx(
        100 * steps * least_seconds_of(w["ffn"]) / 0.002)
    assert read("peak_mem_gib") == pytest.approx(3.0)
    assert read("sampler_ms_per_step") == pytest.approx(50.0 * run.requests / steps)
    br = tracing.breakdown(reading)
    assert br["device_ops"][0] == ["attn_sm90_two_pass<40, true, 0>", 0.004]
    assert br["idle_gaps"] == [["decode: aten::conv2d", 0.001]]


def test_rooflines_are_silent_where_no_kernel_ran():
    cell = tiny_cell("sd-v1-4.or.512.b8")
    reading = tracing.Reading(seconds={}, window=(0, 10), busy_s=0.0, gaps=[])
    run = _fake_run(cell, reading)
    for m in ("attn_roofline", "ffn_roofline", "glue_ms_per_step", "device_idle_share"):
        assert cell.reader(m).read(run) is None
    cifar = tiny_cell("cifar10-pair.or_sde.b100")
    assert cifar.reader("attn_roofline").read(_fake_run(cifar, reading)) is None
