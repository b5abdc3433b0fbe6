"""The ported SD pipeline's ``sd_ab`` baseline under the packed-layout lever
``_CROSS_IMPL="nat"`` vs the JAX pipeline under the same lever, fp32 on the
CPU: the case and tolerances of ``test_torch_sd_levers.py`` (kappa within
1e-4, latents and likelihoods within 1e-2 of their scale, as the ``sd_*``
baselines under the default lever), split from that file so that each stays
under a minute."""

import pytest
import torch
from test_torch_sd_levers import check_cross_impl_nat, jax_flash_stack  # noqa: F401
from test_torch_sd_pipeline import KAPPA_ATOL, STEPS, stacks  # noqa: F401  (fixtures)

torch.set_num_threads(1)


@pytest.mark.parametrize("method,kappa_atol,scaled_atol,prompts,steps", [
    ("sd_ab", KAPPA_ATOL, 1e-2, ("a cat", "a dog"), STEPS),
])
def test_methods_under_cross_impl_nat_match_jax(stacks, jax_flash_stack, monkeypatch, method,
                                                kappa_atol, scaled_atol, prompts, steps):
    check_cross_impl_nat(stacks, jax_flash_stack, monkeypatch, method, kappa_atol,
                         scaled_atol, prompts, steps)
