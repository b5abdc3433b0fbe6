"""The ported SD pipeline's ``sd_*`` baselines vs the JAX pipeline, fp32 on
the CPU: the golden tiny config, the carried weights and the JAX threefry
draws of ``test_torch_sd_pipeline.py`` (whose fixtures are used here). Split
from ``test_torch_sd_methods.py`` so that each file stays under a minute.

Latents and log-likelihoods within 1e-2 of their scale, kappa within 1e-4.
The conditional and the unconditional prompt differ in many tokens, so the
guidance term 2 |dsigma| g (v_obj - v_unc) multiplies the UNet's fp32 noise
by more than ``or``'s two near-equal prompts do, and the randomly weighted
tiny UNet meets ill-conditioned forwards: over seeds 7, 11, 12 and two
prompt pairs the six baselines differ from JAX by 6e-6 to 4.5e-3 of scale
on the latents, and at the worst spot found (``sd_ab_or``, first step) an
fp64 run of the same UNet shows the JAX fp32 output off by 1.3e-3 and the
port's by 2.4e-5. A wrong term in the step would show at 1e-1 or more.
"""

import pytest
import torch
from test_torch_sd_pipeline import (  # noqa: F401  (stacks is a fixture)
    check_method_matches_jax,
    stacks,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("method", ["sd_ab", "sd_ba", "sd_ab_or", "sd_ba_or", "sd_a", "sd_b"])
def test_sd_baseline_matches_jax_trajectory(stacks, method):
    got, _ = check_method_matches_jax(stacks, method, prompts=("a cat", "a dog"),
                                      scaled_atol=1e-2)
    tr = got["traces"]
    # the baselines move the unconditional likelihood and set ll_bg = ll_obj
    assert not torch.any(tr["final_ll_uncond"] == 1.0)
    assert torch.equal(tr["ll_bg"], tr["ll_obj"])
