"""Tensor-parallel SD UNet inference (``superdiff_tpu_torch/parallel/tp.py``)
on a gloo world of 4 CPU processes, against the JAX package: the tiny
SD UNet on the einsum lowering, fp32, as JAX's ``tests/test_tp.py`` runs
it (drawn non-zero weights, 16 x 16 latents, 7-token contexts).

* The forward at (data 2, tp 2) and (data 1, tp 4), the batch split over
  data, against JAX's replicated forward within 1e-5 of the output's
  largest magnitude (``test_torch_sd_unet.py``'s tolerance; the row-parallel
  partial products are summed in another order).
* The rule table: the same weights split as JAX's ``sd_tp_shardings``
  (its paths mapped to the port's names), the conv tier replicated, and a
  weight whose split dimension does not divide by tp replicated.
* The pinned collectives of one forward: per spatial transformer 4
  all-reduces and 1 all-gather (16 transformers in the tiny topology), and
  no other collective.
* A kernel configuration at tp > 1 raises.
* The 3-axis layout (data 1, model 2, tp 2; JAX's
  ``test_ensemble_tp_3axis_matches_per_model_forwards``): two differently
  drawn UNets, each model group running its own split over tp, the
  outputs all-gathered over model into (2, B, ...), against JAX's
  per-model forwards within 1e-5 of the largest magnitude; the stacked
  rule table puts ``model`` first on every spec and the tp rule one dim to
  the right.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_dist import World
from torch_parity import draw_params

from superdiff_tpu.models.sd.unet import SDUNet as JaxSDUNet
from superdiff_tpu.models.sd.unet import SDUNetConfig as JaxSDUNetConfig
from superdiff_tpu.parallel import sd_tp_shardings as jax_shardings
from superdiff_tpu_torch.models.from_jax import state_dict_from_flax, torch_key

W = 4
N_BLOCKS = 16  # 6 down + 1 mid + 9 up spatial transformers
EINSUM = dict(attn_impl="einsum", ffn_impl="einsum")


@pytest.fixture(scope="module")
def runs():
    jcfg = dataclasses.replace(JaxSDUNetConfig.tiny(), **EINSUM)
    unet = JaxSDUNet(jcfg, dtype=jnp.float32)
    example = (jnp.zeros((1, 8, 8, 4)), jnp.zeros(()), jnp.zeros((1, 7, 64)))
    params, other = (draw_params(unet, *example, seed=s) for s in (5, 6))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    base = dict(params=state_dict_from_flax(params), impl=EINSUM, x=torch.from_numpy(x),
                ctx=torch.from_numpy(ctx))
    world = World(W, {"tp_forward:2": dict(base, data=2, tp=2),
                      "tp_forward:4": dict(base, data=1, tp=4),
                      "tp_rules": dict(base),
                      "tp_ensemble": dict(base, data=1, model=2, tp=2, params=[
                          base["params"], state_dict_from_flax(other)])})
    fwd = jax.jit(lambda p, a, c: unet.apply({"params": p}, a, jnp.float32(500.0), c))
    ref = np.asarray(fwd(params, x, ctx))
    per_model = np.stack([ref, np.asarray(fwd(other, x, ctx))])
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "tp"))
    flat = jax.tree_util.tree_flatten_with_path(jax_shardings(params, mesh))[0]
    jax_split = {torch_key("/".join(k.key for k in kp)) for kp, s in flat if s.spec != ()}
    return world.join(), ref, jax_split, per_model


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_matches_jax(runs, tp):
    outs, ref, _, _ = runs
    scale = np.abs(ref).max()
    for out in outs:
        got = out[f"tp_forward:{tp}"]["out"].numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_rules_match_jax(runs, tp):
    outs, _, jax_split, _ = runs
    got = outs[0][f"tp_forward:{tp}"]
    split = {n for n, s in got["specs"].items() if s != ()}
    assert split == jax_split
    assert not any("conv" in n for n in split)
    assert got["specs"]["mid_attn.block_0.attn1.to_q.weight"] == ("tp", None)
    assert got["specs"]["mid_attn.block_0.attn1.to_out.weight"] == (None, "tp")
    # the weights are this rank's slices: q/k/v rows, to_out columns, the
    # GEGLU value and gate rows of one F slice
    shapes = got["shapes"]
    assert shapes["mid_attn.block_0.attn1.to_q.weight"] == (64 // tp, 64)
    assert shapes["mid_attn.block_0.attn1.to_out.weight"] == (64, 64 // tp)
    assert shapes["mid_attn.block_0.ff_geglu.proj.weight"] == (2 * 256 // tp, 64)
    assert shapes["mid_attn.block_0.attn1.to_out.bias"] == (64,)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_collective_counts(runs, tp):
    outs, _, _, _ = runs
    for out in outs:
        counts = out[f"tp_forward:{tp}"]["counts"]
        assert counts["all_reduce"] == 4 * N_BLOCKS, counts
        assert counts["all_gather_into_tensor"] == N_BLOCKS, counts
        assert sum(counts.values()) == 5 * N_BLOCKS, counts


def test_tp_indivisible_dim_falls_back_to_replication(runs):
    outs, _, _, _ = runs
    for out in outs:
        odd = out["tp_rules"]["odd"]
        assert odd["block_0.attn1.to_q.weight"] == ()  # 62 rows over tp 4
        assert odd["block_0.attn1.to_k.weight"] == ("tp", None)


def test_tp_kernel_configuration_raises(runs):
    outs, _, _, _ = runs
    for out in outs:
        assert "einsum lowering" in out["tp_rules"]["raised"]


def test_ensemble_tp_3axis_matches_per_model_forwards(runs):
    outs, _, _, per_model = runs
    scale = np.abs(per_model).max()
    for out in outs:
        got = out["tp_ensemble"]
        assert got["out"].shape == per_model.shape
        np.testing.assert_allclose(got["out"].numpy() / scale, per_model / scale, rtol=0,
                                   atol=1e-5)
        specs = got["specs"]
        assert specs["mid_attn.block_0.attn1.to_q.weight"] == ("model", "tp", None)
        assert specs["mid_attn.block_0.ff_out.weight"] == ("model", None, "tp")
        assert all(s[0] == "model" for s in specs.values())
