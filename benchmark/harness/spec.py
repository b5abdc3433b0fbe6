"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root names the cells, configurations and metrics;
each part lives in a file of its own under ``benchmark/``, found by that
name, so a later change adds a cell, a configuration or a metric by adding
files and entries, and edits none:

* ``configs/<config>.json``: the configuration's sizes and dtypes, with
  ``reference`` naming its plain reference ``reference/<reference>.py``;
* ``traffic/<traffic>.json``: the mix's parameters, with ``driver`` naming
  the code that drives that kind of traffic, ``drivers/<driver>.py``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _check_name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str) -> ModuleType:
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(kind: str, name: str) -> str:
    return f"benchmark.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its parts loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the end-to-end entries this cell reports
    per_layer: list  # the per-layer entries this cell reports
    bench_dir: str = HERE

    def driver(self) -> ModuleType:
        name = _check_name(self.traffic["driver"])
        return load_module(os.path.join(self.bench_dir, "drivers", f"{name}.py"),
                           _modname("drivers", name))

    def reference(self) -> ModuleType:
        name = _check_name(self.config["reference"])
        return load_module(os.path.join(self.bench_dir, "reference", f"{name}.py"),
                           _modname("reference", name))

    def reader(self, metric: str) -> ModuleType:
        name = _check_name(metric)
        return load_module(os.path.join(self.bench_dir, "metrics", f"{name}.py"),
                           _modname("metrics", name))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT, bench: Optional[dict] = None,
              bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``), its
    configuration and traffic read from their files under ``bench_dir``."""
    bench = bench if bench is not None else load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    config = load_json(os.path.join(bench_dir, "configs", f"{_check_name(w['config'])}.json"))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{_check_name(w['traffic'])}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)
