"""The port's SD sampler arithmetic, every method, against the JAX sampler
with an analytic stand-in for the UNet.

The parity tests through the tiny UNet (``test_torch_sd_pipeline.py``,
``test_torch_sd_methods.py``) inherit that network's fp32 conditioning. Here
both samplers integrate the same smooth closed-form velocity field
``v = 0.5 tanh(a(t) x + 0.5 roll(x) + mean(ctx))`` (with conditioning dedup it
tiles the shared latent where the context enters, as the UNet does), so what
is compared is the step itself: guidance, the kappa policies, the Itô
estimators, the second trajectory of the ``sd_*`` baselines and, for
``and_ode``, the jvp and the divergence signs. Same JAX threefry draws on
both sides. fp32: kappa within 1e-4 (absolute and relative: the AND kappa
is not confined to [0, 1]), latents and log-likelihoods within 1e-5
of their largest magnitude.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.core import ito as jito
from superdiff_tpu.pipelines import sd as jsd
from superdiff_tpu_torch.pipelines import sd

torch.set_num_threads(1)

STEPS, HW, BATCH, SEED = 4, 64, 3, 5


class _JaxField:
    @staticmethod
    def apply(_variables, x, tt, ctx):
        x = jnp.tile(x, (ctx.shape[0] // x.shape[0], 1, 1, 1))
        c = jnp.mean(ctx, axis=(1, 2)).reshape(-1, 1, 1, 1)
        return 0.5 * jnp.tanh((0.3 + 1e-3 * tt) * x + 0.5 * jnp.roll(x, 1, axis=1) + c)


def _torch_field(x, tt, ctx):
    x = x.repeat(ctx.shape[0] // x.shape[0], 1, 1, 1)
    c = ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
    return 0.5 * torch.tanh((0.3 + 1e-3 * tt) * x + 0.5 * torch.roll(x, 1, dims=1) + c)


def _noise():
    shape = (BATCH, HW // 8, HW // 8, 4)
    init_key, path_key = jax.random.split(jax.random.PRNGKey(SEED))
    keys = [jax.random.fold_in(path_key, i) for i in range(STEPS)]
    return (np.asarray(jax.random.normal(init_key, shape)),
            np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys]),
            np.stack([np.asarray(jito.rademacher(k, shape)) for k in keys]))


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "tiled"])
@pytest.mark.parametrize("method", sd.METHODS)
def test_sampler_step_matches_jax(method, dedup):
    rng = np.random.default_rng(1)
    # contexts whose means differ by O(1): the AND kappas divide by
    # sum((v_obj - v_bg)^2), which near-equal contexts make ill-conditioned
    ctxs = [(off + 0.4 * rng.standard_normal((BATCH, 77, 8))).astype(np.float32)
            for off in (0.6, -0.6, 0.0)]
    kw = dict(num_inference_steps=STEPS, height=HW, width=HW, cond_dedup=dedup,
              lift=0.3, kappa_fixed=0.4, temperature=1.0, logp=0.1)
    jmod = types.SimpleNamespace(unet=_JaxField, grid_train_timesteps=1000)
    ref_x, ref = jax.jit(lambda key, *c: jsd.superdiff_sd_sample(
        jmod, {}, method, key, *c, jsd.SDPipelineConfig(fused_kernel=False, **kw)))(
            jax.random.PRNGKey(SEED), *map(jnp.asarray, ctxs))
    mod = types.SimpleNamespace(unet=_torch_field)
    got_x, got = sd.superdiff_sd_sample(mod, method, *map(t, ctxs), sd.SDPipelineConfig(**kw),
                                        noise=_noise())
    assert set(got) == set(ref)
    for key in ref:
        a, b = got[key].numpy(), np.asarray(ref[key])
        assert a.shape == b.shape and a.dtype == np.float32, key
        if key == "kappa":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=key)
        else:
            scale = np.abs(b).max()
            np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-5, err_msg=key)
    scale = np.abs(np.asarray(ref_x)).max()
    np.testing.assert_allclose(got_x.numpy() / scale, np.asarray(ref_x) / scale, rtol=0, atol=1e-5)
