"""Shared helpers of the ``test_torch_*`` parity tests (JAX package vs port).

The JAX side keeps to the CPU (tests/conftest.py); arrays cross between the
two frameworks as numpy.
"""

import dataclasses

import jax
import numpy as np
import torch

from superdiff_tpu_torch.models.from_jax import state_dict_from_flax


def draw_params(module, *example_args, seed=0):
    """A Flax ``params`` tree for ``module`` with numpy draws, shaped by
    ``eval_shape`` (no XLA compile): fan-in-scaled normal kernels and
    embeddings, ``1 + 0.1 N`` scales, ``0.1 N`` biases."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example_args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape)
        if len(s.shape) > 1:
            return (z / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return ((1.0 if "scale" in name else 0.0) + 0.1 * z).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def carry(torch_module, params):
    """Load a Flax params tree into ``torch_module`` (strict); returns it."""
    torch_module.load_state_dict(state_dict_from_flax(params), strict=True)
    return torch_module.eval()


def same_config(port_cfg, jax_cfg, unread=()):
    """The port's config holds the JAX config's fields at its values, less
    ``unread``: JAX's fields that no code of either package reads (or that
    only JAX's struct2seq reads), which the port does not carry."""
    p, j = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)
    assert set(j) - set(p) == set(unread) and set(p) <= set(j), set(p) ^ set(j)
    assert p == {k: j[k] for k in p}


def t(a):
    """numpy / jax array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(a))

