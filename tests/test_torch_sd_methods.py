"""The ported SD pipeline's ODE methods vs the JAX pipeline, fp32 on the
CPU: the golden tiny config, the carried weights and the JAX threefry draws
of ``test_torch_sd_pipeline.py`` (whose fixtures and defaults are used here:
kappa within 1e-4, latents and log-likelihoods within 1e-5 of their largest
magnitude). The ``sd_*`` baselines are held in ``test_torch_sd_baselines.py``
(split off so that each file stays under a minute).

Looser, with the reason:

* ``and_ode``: kappa 1e-2, everything else 1e-3 of scale. Its divergences are
  tangents through the norms' fast variance ``E[x^2] - E[x]^2``, whose
  tangent ``2 E[x dx] - 2 E[x] E[dx]`` cancels: against an fp64 run of the
  same UNet the fp32 tangents are off by 1e-4 (port) and 3e-5 (JAX) at a
  largest magnitude of 2.2, while the values agree to 2e-6. sigma * div then
  enters kappa (measured 4e-3 off at the third step) and the likelihoods
  (4e-4 of scale).

``and_ode`` is the slice-as-a-whole check of the tangent rules: one
``torch.func.jvp`` through the tiny UNet against ``jax.jvp`` through the JAX
UNet, with the same Rademacher probes.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_sd_pipeline import (  # noqa: F401  (stacks is a fixture)
    BATCH,
    PROMPTS,
    SEED,
    _cfg,
    _close,
    _jax_noise,
    check_method_matches_jax,
    stacks,
)

from superdiff_tpu_torch.pipelines import sd

torch.set_num_threads(1)


@pytest.mark.parametrize("method,kappa_atol,scaled_atol",
                         [("and_ode", 1e-2, 1e-3), ("avg_ode", 1e-4, 1e-5)])
def test_ode_method_matches_jax_trajectory(stacks, method, kappa_atol, scaled_atol):
    got, _ = check_method_matches_jax(stacks, method, kappa_atol=kappa_atol,
                                      scaled_atol=scaled_atol)
    tr = got["traces"]
    if method == "avg_ode":
        # no log-likelihood is tracked for the noise-free averaged step
        assert torch.all(tr["kappa"] == 0.4)
        assert torch.all(tr["ll_obj"] == 1.0) and torch.all(tr["ll_bg"] == 1.0)
    else:
        assert torch.isfinite(tr["kappa"]).all() and not torch.all(tr["ll_obj"] == 1.0)


def test_and_ode_dedup_matches_tiled(stacks):
    """The shared probe through the dedup forward gives the tiled forward's
    used values (the uncond group's tangent is discarded). One step, so the
    tangents' fp32 noise (module docstring) is not fed back through kappa."""
    _, mod = stacks
    noise = _jax_noise()
    on, off = (sd.generate(mod, "and_ode", *PROMPTS, seed=SEED, batch_size=BATCH,
                           cfg=dataclasses.replace(_cfg(d), num_inference_steps=1),
                           noise=noise, decode=False) for d in (True, False))
    _close(on["latents"], off["latents"], atol=1e-4)
    _close(on["traces"]["ll_obj"], off["traces"]["ll_obj"], atol=1e-2)
    np.testing.assert_allclose(on["traces"]["kappa"].numpy(), off["traces"]["kappa"].numpy(),
                               rtol=0, atol=1e-2)


def test_probes_are_drawn_when_not_given(stacks):
    _, mod = stacks
    one = dataclasses.replace(_cfg(True), num_inference_steps=1)
    a, b = (sd.generate(mod, "and_ode", "a cat", "a dog", seed=5, batch_size=1, cfg=one,
                        decode=False)["latents"] for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all()
