"""The ported SD pipeline under the packed-layout lever ``_CROSS_IMPL="nat"``
vs the JAX pipeline under the same lever, fp32 on the CPU: the golden tiny
config, carried weights and JAX threefry draws of
``test_torch_sd_pipeline.py``, with the JAX UNet under ``attn_impl="flash_eod"``
(the port's default) so that both packages send the short rows through
``flash_mha``. Tolerances as for each method under the default lever
(``test_torch_sd_pipeline.py``, ``test_torch_sd_methods.py``), but for
``and_ode``, which runs one step. Its kappa feeds the UNet's fp32 noise back
into the trajectory: over three steps, switching the lever moves the JAX
trajectory against itself by 9e-4 of the latents' scale and 2.5e-3 of the
likelihoods', and the port lies 1.1e-3, 4.9e-3 and 5.6e-2 in kappa from
JAX under it (measured). After one step the latents agree
to 1.1e-5 of their scale (held to 1e-4) and kappa to 5e-4 (held to 1e-2);
the likelihoods carry sigma_0 = 14.6 times the Hutchinson divergence, whose
fp32 tangent noise (``test_torch_sd_methods.py``) puts them 2.1e-3 of their
scale apart under this lever and 6e-3 under the default one: held to 1e-2,
as the ``sd_*`` baselines. The ``and_ode`` case runs in
``test_torch_sd_levers_ode.py`` and the ``sd_ab`` one in
``test_torch_sd_levers_baseline.py`` (split off so that each file stays
under a minute).
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch
from test_torch_sd_pipeline import (  # noqa: F401  (stacks is a fixture)
    PROMPTS,
    STEPS,
    _close,
    check_method_matches_jax,
    stacks,
)

from superdiff_tpu.models.sd import unet as junet
from superdiff_tpu.ops.pallas import flash_attention as jfa
from superdiff_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_flash_stack(stacks):
    """The JAX modules of ``stacks`` with the UNet under ``attn_impl="flash_eod"``
    (the port's default), so that the short rows go through ``flash_mha``
    and its ``_CROSS_IMPL`` lever in JAX too; same parameters."""
    jmod, _ = stacks
    ucfg = dataclasses.replace(jmod.unet.config, attn_impl="flash_eod")
    return dataclasses.replace(jmod, unet=junet.SDUNet(ucfg, dtype=jnp.float32))


@pytest.mark.parametrize("method,kappa_atol,scaled_atol,prompts,steps", [
    ("and", 1e-3, 1e-4, PROMPTS, STEPS),  # tolerances of the default-lever tests
])
def test_methods_under_cross_impl_nat_match_jax(stacks, jax_flash_stack, monkeypatch, method,
                                                kappa_atol, scaled_atol, prompts, steps):
    check_cross_impl_nat(stacks, jax_flash_stack, monkeypatch, method, kappa_atol,
                         scaled_atol, prompts, steps)


def check_cross_impl_nat(stacks, jax_flash_stack, monkeypatch, method, kappa_atol,
                         scaled_atol, prompts, steps):
    """``_CROSS_IMPL="nat"`` in both packages: the 64- and 16-token self- and
    cross-attention rows of the 64 px UNet reach ``_kernel_mh_nat`` (the
    Pallas kernel in interpret mode in JAX, its plain version here; and_ode's
    tangents through the plain attention in both)."""
    for m in (fa, jfa):
        monkeypatch.setattr(m, "_CROSS_IMPL", "nat")
    names = []
    real = fa._plain

    def spy(name, *a):
        names.append(name)
        return real(name, *a)

    monkeypatch.setattr(fa, "_plain", spy)
    _, mod = stacks
    got, ref = check_method_matches_jax((jax_flash_stack, mod), method, prompts=prompts,
                                        kappa_atol=kappa_atol, scaled_atol=scaled_atol,
                                        steps=steps)
    if method == "and_ode":
        _close(got["latents"], ref["latents"], atol=1e-4)
    # one forward per step; 10 transformer blocks at 64 and 16 tokens, each
    # a self- and a cross-row (the 4- and 1-token rows do not tile)
    assert names == ["_kernel_mh_nat"] * 20 * steps
