"""The port stands alone: importing it pulls in no JAX and touches no CUDA,
no file of it imports JAX, Flax or the JAX package, and its kernels are
built from source or raise (never skipped or replaced)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "superdiff_tpu_torch"


def _run(code, **env):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env={**os.environ, **env})


def test_import_pulls_in_no_jax_and_no_cuda():
    code = (
        "import sys, torch\n"
        "import superdiff_tpu_torch, superdiff_tpu_torch.pipelines.sd\n"
        "import superdiff_tpu_torch.pipelines.cifar, superdiff_tpu_torch.ops.fused_step\n"
        "import superdiff_tpu_torch.ops.flash_attention, superdiff_tpu_torch.ops.geglu_ffn\n"
        "import superdiff_tpu_torch.core.dsm, superdiff_tpu_torch.train, superdiff_tpu_torch.data\n"
        "import superdiff_tpu_torch.eval, superdiff_tpu_torch.utils, superdiff_tpu_torch.models.mlp\n"
        "import superdiff_tpu_torch.models.inception, superdiff_tpu_torch.pipelines.protein\n"
        "import superdiff_tpu_torch.models.protein.proteus, superdiff_tpu_torch.cli\n"
        "import superdiff_tpu_torch.models.protein.convert\n"
        "import superdiff_tpu_torch.models.protein.struct2seq, superdiff_tpu_torch.data.pdb\n"
        "import superdiff_tpu_torch.train.se3_trainer, superdiff_tpu_torch.eval.clip_metrics\n"
        "import superdiff_tpu_torch.eval.struct_metrics, superdiff_tpu_torch.eval.novelty\n"
        "import superdiff_tpu_torch.eval.self_consistency, superdiff_tpu_torch.eval.embed_viz\n"
        "import superdiff_tpu_torch.utils.hub\n"
        "import superdiff_tpu_torch.eval.nll, superdiff_tpu_torch.eval.fld\n"
        "import superdiff_tpu_torch.eval.tifa, superdiff_tpu_torch.eval.ordering\n"
        "import superdiff_tpu_torch.eval.aggregate, superdiff_tpu_torch.models.registry\n"
        "import superdiff_tpu_torch.models.normalization, superdiff_tpu_torch.models.ncsn_layers\n"
        "import superdiff_tpu_torch.examples.superposition_2d\n"
        "import superdiff_tpu_torch.utils.profiling, superdiff_tpu_torch.utils.traceparse\n"
        "import superdiff_tpu_torch.utils.bench_io\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'superdiff_tpu')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "import superdiff_tpu_torch.ops._build as b\n"
        "assert not b._libs\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_no_file_imports_jax_flax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|superdiff_tpu)(\.|\s|$)", re.M)
    files = (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("torch_*.py")))
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_protein_entry_points_default_to_the_card():
    """``SE3Diffuser.default()`` (so ``compose``, whose device is its
    diffuser's) and the protein CLI run on ``cuda`` unless told otherwise:
    without a card they raise instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run")
    proc = _run("from superdiff_tpu_torch.models.protein import SE3Diffuser\n"
                "SE3Diffuser.default()\n")
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    proc = _run("from superdiff_tpu_torch import cli\n"
                "cli.main(['protein', '--length', '4', '--num_t', '2', '--out_dir', "
                "'/nonexistent/protein'])\n")
    assert proc.returncode != 0 and "CUDA" in proc.stderr


@pytest.mark.parametrize("code", [
    "from superdiff_tpu_torch import cli\n"
    "cli.main(['sd', '--preset', 'tiny', '--num_inference_steps', '1', '--out_dir', "
    "'/nonexistent/sd'])\n",
    "from superdiff_tpu_torch import cli\n"
    "cli.main(['cifar', '--mode', 'train', '--n_iters', '1', '--workdir', "
    "'/nonexistent/cifar'])\n",
    "from superdiff_tpu_torch.models.protein import struct2seq as s\n"
    "s.init_mpnn_esm(s.MPNNESMConfig.tiny())\n",
    "from superdiff_tpu_torch.models.protein import struct2seq as s\n"
    "s.load_mpnn_esm(c_s=32, c_z=16)\n",
    "import numpy as np\n"
    "from superdiff_tpu_torch.eval import embed_viz\n"
    "embed_viz.tm_affinity([np.zeros((4, 3)), np.ones((5, 3))])\n",
    "import numpy as np\n"
    "from superdiff_tpu_torch.eval import fld\n"
    "fld.fld(np.zeros((4, 3)), np.ones((5, 3)), np.ones((5, 3)), n_steps=1)\n",
    "import numpy as np\n"
    "from superdiff_tpu_torch.eval import fld\n"
    "fld.fit_mog_bandwidths(np.zeros((4, 3)), np.ones((5, 3)), n_steps=1)\n",
    "from superdiff_tpu_torch.examples import superposition_2d as s\n"
    "s.train_model('up', 1)\n",
    "from superdiff_tpu_torch.examples import superposition_2d as s\n"
    "s.main(['--n_iters', '1', '--n_steps', '1', '--outdir', '/nonexistent/s2d'])\n",
])
def test_new_entry_points_default_to_the_card(code):
    """The ``sd`` and ``cifar`` commands, the struct2seq constructors, the
    structure-map affinity, FLD and its bandwidth fit, and the 2-D
    walkthrough (its trainer and its ``main``) run on ``cuda`` unless told
    otherwise: without a card they raise instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run")
    proc = _run(code)
    assert proc.returncode != 0 and ("CUDA" in proc.stderr or "cuda" in proc.stderr), \
        proc.stderr[-1500:]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from superdiff_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("SUPERDIFF_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(_build.KernelCompileError, match="nvcc"):
        _build.build_all()


def test_wrappers_have_no_fallback():
    """A CUDA tensor goes to the kernel or raises: no wrapper catches."""
    files = sorted((PKG / "ops").glob("*.py"))
    assert {f.name for f in files} >= {"_build.py", "fused_step.py", "sd_fused_step.py"}
    for f in files:
        assert not re.search(r"^\s*(try|except)\b", f.read_text(), re.M), f.name


def test_chip_smoke_refuses_without_a_card():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
