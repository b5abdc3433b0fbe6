"""Tensor parallelism through the whole SD sampler
(``superdiff_tpu_torch/parallel/tp.py``) on a gloo world of 4 CPU
processes, against the JAX package (JAX's ``tests/test_tp.py::
test_tp_full_composition_sampler_matches_replicated``): the 3-step ``or``
sampler of ``test_torch_sd_pipeline.py`` (tiny UNet / CLIP / VAE, fp32,
64 px, batch 2, JAX's threefry draws) with the UNet split over tp 4 on the
einsum lowering, against JAX's replicated fp32 run at JAX's tolerance,
rtol = atol = 5e-4 on the latents and kappa (the row-parallel sums'
reassociation, magnified by the trajectory).
"""

import numpy as np
import pytest
import torch
from test_torch_sd_pipeline import _cfg, _jax_generate, _jax_noise, stacks  # noqa: F401
from torch_dist import World

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(stacks):
    jmod, mod = stacks
    noise = _jax_noise()
    world = World(4, {
        "tp_sampler": dict(unet=mod.unet.state_dict(), text=mod.text.state_dict(),
                           vae=mod.vae.state_dict(), batch=2, cfg=_cfg(False),
                           noise=tuple(torch.from_numpy(a.copy()) for a in noise[:2]))})
    ref = _jax_generate(jmod, "or", ("a cat", "a dog"), 7)
    return world.join(), ref


def test_tp_sampler_matches_replicated(runs):
    outs, ref = runs
    lat, kappa = np.asarray(ref["latents"]), np.asarray(ref["traces"]["kappa"])
    for out in outs:
        got = out["tp_sampler"]
        np.testing.assert_allclose(got["latents"].numpy(), lat, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got["kappa"].numpy(), kappa, rtol=5e-4, atol=5e-4)
