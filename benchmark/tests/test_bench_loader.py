"""A configuration, a cell and a per-layer metric are added by adding files
and entries: the loader finds each by its name, and no file that is there
changes."""

import json
import os
import shutil

from benchmark.harness import runner, spec


def _copy(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    return bench_dir, json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


def test_every_cell_of_the_benchmark_loads():
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.driver().Driver
        assert cell.reference().build
        assert cell.traffic["limits"]
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        assert {m["name"] for m in cell.end_to_end} >= {"samples_per_s", "setup_s"}


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    bench_dir, bench = _copy(tmp_path)
    before = {p: open(p, "rb").read() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.load(open(bench_dir / "configs" / "sd-v1-4.json"))
    cfg["name"] = "sd-v1-4-wide"
    (bench_dir / "configs" / "sd-v1-4-wide.json").write_text(json.dumps(cfg))
    traffic = json.load(open(bench_dir / "traffic" / "or.512.b8.json"))
    traffic["height"] = traffic["width"] = 768
    (bench_dir / "traffic" / "or.768.b8.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "requests_in_window.py").write_text(
        "def read(run):\n    return run.requests or None\n")
    bench["configs"].append({"name": "sd-v1-4-wide", "source": "https://example.org/x",
                             "file": "benchmark/configs/sd-v1-4-wide.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "sd-v1-4-wide.or.768.b8", "config": "sd-v1-4-wide",
                               "traffic": "or.768.b8", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_in_window", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "pipeline",
                               "moves": "samples_per_s",
                               "workloads": ["sd-v1-4-wide.or.768.b8"]})
    cell = spec.find_cell("sd-v1-4-wide.or.768.b8", bench=bench, bench_dir=str(bench_dir))
    assert cell.config["name"] == "sd-v1-4-wide" and cell.traffic["height"] == 768
    assert [m["name"] for m in cell.per_layer][-1] == "requests_in_window"
    fake = type("Run", (), {"requests": 3})()
    assert cell.reader("requests_in_window").read(fake) == 3
    old = spec.find_cell("sd-v1-4.or.512.b8", bench=bench, bench_dir=str(bench_dir))
    assert "requests_in_window" not in [m["name"] for m in old.per_layer]
    for p, data in before.items():
        assert open(p, "rb").read() == data, f"{p} changed"


def test_names_outside_the_alphabet_are_refused():
    import pytest

    for bad in ("../configs/x", "a b", "a/b", ""):
        with pytest.raises(ValueError):
            spec._check_name(bad)


def test_cache_directories_lie_inside_the_checkout(tmp_path, monkeypatch):
    for var in runner.CACHE_ENV:
        monkeypatch.delenv(var, raising=False)
    runner.set_environment(str(tmp_path))
    for var in runner.CACHE_ENV:
        assert os.environ[var].startswith(str(tmp_path) + os.sep)
