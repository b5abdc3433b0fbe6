"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
plain references import nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.harness import runner, spec


def test_top_level_names_are_compared_whole():
    mods = ["superdiff_tpu_torch", "superdiff_tpu_torch.ops", "jaxtyping", "flaxen",
            "superdiff_tpu", "superdiff_tpu.core", "jax", "jaxlib.xla", "optax", "flax.linen"]
    assert runner.forbidden_modules(mods) == sorted(
        ["superdiff_tpu", "superdiff_tpu.core", "jax", "jaxlib.xla", "optax", "flax.linen"])


def test_a_tiny_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.tiny import tiny_cell, run_tiny\n"
        "from benchmark.harness.runner import forbidden_modules\n"
        "for n in ('sd-v1-4.or.512.b1', 'cifar10-pair.or_sde.b100'):\n"
        "    run_tiny(tiny_cell(n))\n"
        "assert 'superdiff_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_references_import_nothing_of_the_program():
    ref_dir = os.path.join(spec.HERE, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, f))}
            assert not tops & {"superdiff_tpu_torch", "superdiff_tpu", "jax", "flax"}, f
            assert tops <= {"__future__", "math", "zlib", "numpy", "torch", "contextlib",
                            "benchmark"}, (f, tops)


def test_the_harness_imports_the_program_only_inside_the_drivers():
    for sub in ("harness", "metrics", "reference"):
        d = os.path.join(spec.HERE, sub)
        for f in os.listdir(d):
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(d, f))}
                assert "superdiff_tpu_torch" not in tops, (sub, f)
