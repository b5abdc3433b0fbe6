"""The ported CIFAR joint sampler vs the JAX pipeline in SDE mode (OR and
avg), fp32 on the CPU; the set-up and the tolerances are in
``tests/torch_cifar_parity.py``."""

import pytest
import torch
from torch_cifar_parity import LABELS, build_ensemble, check_generator, check_golden

from superdiff_tpu_torch.pipelines import cifar

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ensemble():
    return build_ensemble()


@pytest.mark.parametrize("operator", ["or", "avg"])
def test_generator_matches_jax(ensemble, monkeypatch, operator):
    check_generator(ensemble, monkeypatch, "sde", operator)


def test_generator_draws_from_a_seeded_generator(ensemble):
    *_, cfg, models = ensemble
    generate = cifar.make_generator(models, cfg, n_steps=2, labels=LABELS)
    a, b = (generate(torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.isfinite(a[0]).all()


@pytest.mark.parametrize("mode,operator", [("sde", "and"), ("ode", "and"), ("flow", "or")])
def test_unknown_mode_or_operator_raises(ensemble, mode, operator):
    *_, cfg, models = ensemble
    generate = cifar.make_generator(models, cfg, mode=mode, operator=operator, n_steps=1)
    with pytest.raises(ValueError, match="unknown mode / operator"):
        generate(torch.Generator().manual_seed(0))


def test_golden_trajectory_reproduced():
    """tests/golden/cifar.npz, SDE + OR (zero-score nets: see torch_cifar_parity)."""
    check_golden("sde", "or")
