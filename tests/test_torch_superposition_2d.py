"""The port's 2-D superposition walkthrough
(``superdiff_tpu_torch/examples/superposition_2d.py``) against the JAX
example (``examples/superposition_2d.py``), fp32 on the CPU.

Two MLP score nets trained by the JAX example's ``train_model`` (300
iterations: the parameters only have to be the same in both packages) are
carried into the port; the three compositions (``or_sde``, ``or_ode``,
``avg_sde``) run 20 steps from JAX's initial draw with JAX's per-step
normals / probes (``fold_in(key, i)``) handed in: x_0 and logq within 1e-5
of their largest element. The port's data helper draws JAX's points from
JAX's indices and normals exactly, and one short run of the module's
``main`` on the CPU writes its three sample files.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry

from superdiff_tpu.core import SuperposeConfig as JConfig
from superdiff_tpu.core import ito as jito
from superdiff_tpu.core import superpose as jsuperpose
from superdiff_tpu.models import make_stacked_score_fn as jstacked
from superdiff_tpu.models import stack_params
from superdiff_tpu_torch.examples import superposition_2d as s2d
from superdiff_tpu_torch.models.mlp import MLPScoreNet

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N, STEPS = 64, 20


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_superposition_2d", REPO / "examples" / "superposition_2d.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained():
    ex = _jax_example()
    jmodel, p_up = ex.train_model(jax.random.PRNGKey(0), "up", n_iters=300)
    _, p_down = ex.train_model(jax.random.PRNGKey(1), "down", n_iters=300)
    nets = [carry(MLPScoreNet(hidden=(128, 128), out_dim=2), p).requires_grad_(False)
            for p in (p_up, p_down)]
    return ex, jmodel, (p_up, p_down), nets


@pytest.mark.parametrize("name", sorted(s2d.COMPOSITIONS))
def test_compositions_match_jax(trained, name):
    ex, jmodel, params, nets = trained
    score_fn = jstacked(lambda p, t, x, y=None: jmodel.apply({"params": p}, t, x),
                        stack_params(list(params)))
    kw = s2d.COMPOSITIONS[name]
    x1 = jax.random.normal(jax.random.PRNGKey(7), (N, 2))
    key = jax.random.PRNGKey(8)
    x0, logq, nfe = jax.jit(lambda k, x: jsuperpose(
        k, x, score_fn, ex.SCHED, JConfig(n_steps=STEPS, **kw), n_models=2))(key, x1)
    keys = [jax.random.fold_in(key, i) for i in range(STEPS)]
    draw = ((lambda k: jito.rademacher(k, (N, 2), jnp.float32)) if kw["mode"] == "ode"
            else (lambda k: jax.random.normal(k, (N, 2))))
    noise = [torch.from_numpy(np.array(draw(k))) for k in keys]
    got_x, got_logq, got_nfe = s2d.sample(nets, name, torch.from_numpy(np.array(x1)),
                                          n_steps=STEPS, noise=noise)
    assert got_nfe == nfe
    for got, ref in ((got_x, x0), (got_logq, logq)):
        ref = np.asarray(ref)
        err, scale = np.abs(got.numpy() - ref).max(), max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-5 * scale, (name, err, scale)


def test_four_gaussians_matches_jax():
    ex = _jax_example()
    key = jax.random.PRNGKey(3)
    ref = np.asarray(ex.four_gaussians(key, 100, "down"))
    k1, k2 = jax.random.split(key)
    idx = torch.from_numpy(np.array(jax.random.randint(k1, (100,), 0, 2)))
    noise = torch.from_numpy(np.array(jax.random.normal(k2, (100, 2))))
    got = s2d.four_gaussians(100, "down", idx=idx, noise=noise, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    drawn = s2d.four_gaussians(1000, "up", generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert (drawn[:, 1] > 0.5).float().mean() > 0.99


def test_module_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    out = s2d.main(["--device", "cpu", "--outdir", str(tmp_path), "--n_iters", "60",
                    "--n_steps", "20", "--n_samples", "64"])
    assert set(out) == set(s2d.COMPOSITIONS)
    for name in s2d.COMPOSITIONS:
        saved = np.load(tmp_path / f"samples_{name}.npy")
        assert saved.shape == (64, 2) and np.isfinite(saved).all()
        np.testing.assert_array_equal(saved, out[name])
    text = capsys.readouterr().out
    assert "or_sde: nfe=20" in text and "or_ode: nfe=40" in text
    assert 0.0 <= s2d.up_fraction(out["or_sde"]) <= 1.0
    assert 0.0 <= s2d.near_centre_fraction(out["or_sde"]) <= 1.0
