"""On the card (``python3 -m pytest benchmark/tests -m chip``): a cell runs
whole through the command and comes out correct, and the control (the
plain reference in fp8, the precision below the configurations' bf16, in
the program's place) comes out not correct at the cells' own size."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import compare, spec

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("name", ["cifar10-pair.or_sde.b100", "sd-v1-4.or.512.b1"])
def test_a_cell_runs_whole(card, name):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
    assert line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("name", ["cifar10-pair.or_sde.b100", "sd-v1-4.or.512.b1"])
def test_the_control_is_not_correct(card, name):
    cell = spec.find_cell(name)
    drv = cell.driver().Driver(cell, 2147483671, card)
    numbers, _ = drv.check([0], control="fp8")
    assert not compare.verdict(numbers, cell.traffic["limits"])[0], numbers
