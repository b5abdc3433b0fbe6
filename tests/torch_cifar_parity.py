"""Shared pieces of the CIFAR pipeline parity tests
(``test_torch_cifar_pipeline_{sde,ode}.py``): the port's ``make_generator``
against JAX ``pipelines/cifar.py::make_generator`` on a tiny ensemble, and
against ``tests/golden/cifar.npz``.

Tiny class-conditioned config (nf 16, ch_mult (1, 2), one res block,
attention at 8 px, 16 px images, batch 4, 3 steps), N = 2 models with drawn
non-zero weights carried from the JAX trees, and the JAX sampler's own
threefry draws handed to the port (rebuilt from the same keys as
``make_generator`` and ``core/superpose.py`` draw them). x0 must agree
within 1e-5 (SDE) or 1e-4 (ODE: the JVP's tangent sums differ by more than
the forward's) of its largest magnitude, and logq within the same fraction
of the log-density increments it accumulates: each step adds a sum over the
image of magnitude ~1e4 (at these weights) and the max-renormalisation
leaves differences of order 1, so fp32 reassociation of those sums, not the
renormalised result, sets the error.

``tests/golden/cifar.npz`` came from nets fresh from Flax's ``model.init``,
whose zero-initialised output layers make every score exactly 0: the golden
pins the sampler's schedule and noise plumbing, not the network or the OR
weights (logq stays 0).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import carry, draw_params

from superdiff_tpu.core import ito as jito
from superdiff_tpu.pipelines import cifar as jcifar
from superdiff_tpu_torch.core import ito, superpose
from superdiff_tpu_torch.pipelines import cifar

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16, eval_batch_size=4)
SHAPE = (4, 16, 16, 3)
STEPS, SEED = 3, 5
LABELS = np.array([0, 3, 7, 9], np.int32)


def jax_noise(seed, mode, steps):
    """make_generator's x1 and superpose's per-step draws for PRNGKey(seed)."""
    init_key, path_key = jax.random.split(jax.random.PRNGKey(seed))
    x1 = np.array(jax.random.normal(init_key, SHAPE))
    keys = [jax.random.fold_in(path_key, i) for i in range(steps)]
    if mode == "ode":
        zs = [jito.rademacher(k, SHAPE, jnp.float32) for k in keys]
    else:
        zs = [jax.random.normal(k, SHAPE, dtype=jnp.float32) for k in keys]
    return x1, np.stack([np.asarray(z) for z in zs])


def build_ensemble():
    """(JAX config, JAX model, its two drawn param trees, port config, the
    two port models carrying those trees)."""
    jcfg = jcifar.CifarConfig(conditioned=True, **TINY)
    jmodel = jcfg.model()
    example = (jnp.zeros((1, 1, 1, 1)), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32))
    params = [draw_params(jmodel, *example, seed=s) for s in (10, 11)]
    cfg = cifar.CifarConfig(conditioned=True, **TINY)
    models = [carry(m, p) for m, p in zip(cifar.build_cifar_models([0, 1], cfg, "cpu"), params)]
    return jcfg, jmodel, params, cfg, models


def close(got, ref, atol, what, scale=None):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    assert scale > 0, what
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=atol, err_msg=what)


def record_increments(monkeypatch):
    """A list that gathers the largest |dlogq| of each step of the port's
    sampler: the ODE step's ``dlogq_ode_vp``, and for the SDE + OR step
    (``fused_sde_step``) ``dlogq_sde_vp`` of the step it took. Its sum is
    the scale of logq's rounding."""
    seen = []
    real_ode, real_step = ito.dlogq_ode_vp, superpose.fused_sde_step

    def ode_spy(*a, **kw):
        out = real_ode(*a, **kw)
        seen.append(out.abs().max().item())
        return out

    def step_spy(sscores, x, eps, logq, da, beta, sigma, dt, **kw):
        new_x, new_logq = real_step(sscores, x, eps, logq, da, beta, sigma, dt, **kw)
        sched = SimpleNamespace(dlog_alpha_dt=lambda _: da, beta=lambda _: beta,
                                sigma=lambda _: sigma)
        seen.append(ito.dlogq_sde_vp(sscores, x, new_x - x, None, dt, sched).abs().max().item())
        return new_x, new_logq

    monkeypatch.setattr(ito, "dlogq_ode_vp", ode_spy)
    monkeypatch.setattr(superpose, "fused_sde_step", step_spy)
    return seen


def check_generator(ensemble, monkeypatch, mode, operator):
    jcfg, jmodel, params, cfg, models = ensemble
    increments = record_increments(monkeypatch)
    gen, _ = jcifar.make_generator(jmodel, params, jcfg, mode=mode, operator=operator,
                                   n_steps=STEPS, labels=jnp.asarray(LABELS))
    ref_x, ref_logq = gen(jax.random.PRNGKey(SEED))
    generate = cifar.make_generator(models, cfg, mode=mode, operator=operator,
                                    n_steps=STEPS, labels=LABELS)
    x0, logq = generate(noise=jax_noise(SEED, mode, STEPS))
    atol = 1e-5 if mode == "sde" else 1e-4
    assert x0.shape == SHAPE and logq.shape == (4, 2)
    close(x0, ref_x, atol, "x0")
    if operator == "avg" and mode == "sde":
        assert not logq.any() and not np.asarray(ref_logq).any()
    else:
        close(logq, ref_logq, atol, "logq", scale=sum(increments))
        assert torch.all(logq.max(-1).values == 0)
    images = cifar.to_uint8(x0)
    assert images.dtype == torch.uint8 and images.shape == SHAPE


def check_golden(mode, operator):
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "cifar.npz"))
    jmodel = jcifar.CifarConfig(**TINY).model()
    init = jax.jit(lambda k: jmodel.init({"params": k, "dropout": jax.random.PRNGKey(0)},
                                         jnp.ones((1, 1, 1, 1)), jnp.zeros((1, 16, 16, 3)),
                                         None)["params"])
    cfg = cifar.CifarConfig(**{**TINY, "n_sample_steps": 4})
    models = [carry(m, jax.device_get(init(jax.random.PRNGKey(s))))
              for m, s in zip(cifar.build_cifar_models([0, 1], cfg, "cpu"), (0, 1))]
    generate = cifar.make_generator(models, cfg, mode=mode, operator=operator)
    x0, logq = generate(noise=jax_noise(42, mode, 4))
    np.testing.assert_allclose(x0.numpy(), golden[f"cifar_{mode}_{operator}_x0"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logq.numpy(), golden[f"cifar_{mode}_{operator}_logq"],
                               rtol=1e-4, atol=1e-4)
