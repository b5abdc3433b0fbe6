"""The ported CIFAR joint sampler vs the JAX pipeline in ODE mode (one
``torch.func.jvp`` per step through both nets), OR and avg, fp32 on the CPU;
the set-up and the tolerances are in ``tests/torch_cifar_parity.py``."""

import pytest
import torch
from torch_cifar_parity import build_ensemble, check_generator, check_golden

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ensemble():
    return build_ensemble()


@pytest.mark.parametrize("operator", ["or", "avg"])
def test_generator_matches_jax(ensemble, monkeypatch, operator):
    check_generator(ensemble, monkeypatch, "ode", operator)


def test_golden_trajectory_reproduced():
    """tests/golden/cifar.npz, ODE + avg (zero-score nets: see torch_cifar_parity)."""
    check_golden("ode", "avg")
