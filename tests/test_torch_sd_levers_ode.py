"""The ported SD pipeline's ``and_ode`` under the packed-layout lever
``_CROSS_IMPL="nat"`` vs the JAX pipeline under the same lever, one step,
fp32 on the CPU. The case and its tolerances (the reason for each:
``test_torch_sd_levers.py``'s docstring), split from that file so that each
stays under a minute."""

import pytest
import torch
from test_torch_sd_levers import check_cross_impl_nat, jax_flash_stack  # noqa: F401
from test_torch_sd_pipeline import PROMPTS, stacks  # noqa: F401  (fixtures)

torch.set_num_threads(1)


@pytest.mark.parametrize("method,kappa_atol,scaled_atol,prompts,steps", [
    ("and_ode", 1e-2, 1e-2, PROMPTS, 1),
])
def test_methods_under_cross_impl_nat_match_jax(stacks, jax_flash_stack, monkeypatch, method,
                                                kappa_atol, scaled_atol, prompts, steps):
    check_cross_impl_nat(stacks, jax_flash_stack, monkeypatch, method, kappa_atol,
                         scaled_atol, prompts, steps)
