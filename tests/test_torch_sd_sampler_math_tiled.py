"""The port's SD sampler arithmetic without conditioning dedup, every method,
against the JAX sampler on the analytic stand-in field of
``test_torch_sd_sampler_math.py`` (its check and tolerances; split from
that file so that each stays under a minute)."""

import pytest
import torch
from test_torch_sd_sampler_math import check_sampler_step

from superdiff_tpu_torch.pipelines import sd

torch.set_num_threads(1)


@pytest.mark.parametrize("dedup", [False], ids=["tiled"])
@pytest.mark.parametrize("method", sd.METHODS)
def test_sampler_step_matches_jax(method, dedup):
    check_sampler_step(method, dedup)
