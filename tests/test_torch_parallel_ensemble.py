"""The stacked oracle's ``mode="vmap"`` and its ensemble-sharded form, and
the joint CIFAR sampler's ``score_mode`` on a data x model mesh
(``superdiff_tpu_torch/models/ensemble.py``, ``pipelines/cifar.py::
make_generator``), on gloo worlds of CPU processes, against the JAX
package.

Two differently drawn tiny class-conditioned ScoreUNets (nf 16, ch_mult
(1, 2), one res block, attention at 8 px, 16 px images, fp32).

* ``mode="vmap"`` (``torch.func.vmap`` over the stacked parameters) against
  JAX's ``make_stacked_score_fn(mode="vmap")``, within 1e-5 of the scores'
  largest magnitude (sums in other orders, as ``test_torch_cifar_unet.py``).
* Model-sharded over a ``model`` axis of 2 ranks (each runs only its own
  net, the scores all-gathered) against one rank, in both modes: the same
  1e-5 (a vmapped convolution over one net's weights and over two sums in
  other orders).
* ``make_generator(score_mode="vmap")`` on a data 2 x model 2 world, 3 SDE
  steps under OR, against ``"unroll"`` on one rank, with injected noise and
  with the generator's own draws (every rank draws the whole batch's, as
  one rank does): x0 within 1e-5 of its largest magnitude, the
  renormalised logq (a difference of running sums of the per-step Itô
  terms) within 1e-4 of its largest magnitude (measured 1.14e-5 on both
  runs, whose logq are O(1) and O(1e3)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import World
from torch_parity import draw_params
import torch_parallel_cases as cases

from superdiff_tpu.models import make_stacked_score_fn as jax_stacked
from superdiff_tpu.models import stack_params as jax_stack
from superdiff_tpu.pipelines import cifar as jcifar
from superdiff_tpu_torch.models.ensemble import stack_params, unstack_params
from superdiff_tpu_torch.models.from_jax import state_dict_from_flax
from superdiff_tpu_torch.pipelines import cifar

torch.set_num_threads(1)

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16, conditioned=True, eval_batch_size=4)
B = 4


def _close(got, ref, scale=None, atol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    assert scale > 0
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def setup():
    jmodel = jcifar.CifarConfig(**TINY).model()
    example = (jnp.zeros((1, 1, 1, 1)), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32))
    params = [draw_params(jmodel, *example, seed=s) for s in (11, 12)]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    labels = np.array([3, 1, 4, 1])
    noise = (rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
             rng.standard_normal((3, B, 16, 16, 3)).astype(np.float32))
    sds = [state_dict_from_flax(p) for p in params]
    base = dict(cfg=TINY, params=sds, labels=torch.from_numpy(labels), t=0.37,
                x=torch.from_numpy(x))
    gen = dict(cfg=TINY, params=sds, labels=torch.from_numpy(labels), mode="sde",
               operator="or", steps=3, seed=5,
               noise=tuple(torch.from_numpy(a) for a in noise))
    two = World(2, {"ensemble_scores:vmap": dict(base, mode="vmap", model=2),
                    "ensemble_scores:unroll": dict(base, mode="unroll", model=2)})
    four = World(4, {"ensemble_generator": dict(gen, model=2, score_mode="vmap")})
    one = {"vmap": cases.ensemble_scores(dict(base, mode="vmap", model=1)),
           "unroll": cases.ensemble_scores(dict(base, mode="unroll", model=1)),
           "gen": cases.ensemble_generator(dict(gen, model=1, score_mode="unroll"))}

    def apply_eval(p, t, xx, y):
        return jmodel.apply({"params": p}, t, xx, y, train=False)

    fn = jax_stacked(apply_eval, jax_stack(params), labels=jnp.asarray(labels), mode="vmap")
    ref = np.asarray(jax.jit(fn)(jnp.float32(0.37), jnp.asarray(x)))
    return dict(ref=ref, one=one, two=two.join(), four=four.join(), noise=noise)


def test_vmap_matches_jax_vmap(setup):
    got = setup["one"]["vmap"]["scores"]
    assert got.shape == (2, B, 16, 16, 3)
    _close(got, setup["ref"])
    _close(setup["one"]["unroll"]["scores"], setup["ref"])


@pytest.mark.parametrize("mode", ["vmap", "unroll"])
def test_model_sharded_matches_one_rank(setup, mode):
    for r, out in enumerate(setup["two"]):
        got = out[f"ensemble_scores:{mode}"]
        assert got["coords"] == {"data": 0, "model": r}
        # each rank ran its own net only (vmap runs the first net of its
        # slice as the functional body)
        assert got["called"] == [r]
        _close(got["scores"], setup["one"][mode]["scores"])


def test_generator_on_data_model_mesh_matches_one_rank(setup):
    ref = setup["one"]["gen"]
    for out in setup["four"]:
        got = out["ensemble_generator"]
        assert got["mesh"] == {"data": 2, "model": 2}
        assert got["x0"].shape == (B, 16, 16, 3) and got["logq"].shape == (B, 2)
        _close(got["x0"], ref["x0"])
        _close(got["logq"], ref["logq"], atol=1e-4)
        y0, lq = got["drawn"]
        _close(y0, ref["drawn"][0])
        _close(lq, ref["drawn"][1], atol=1e-4)
    assert not np.allclose(ref["logq"][:, 0], ref["logq"][:, 1])  # the two nets differ


def test_stack_and_unstack_params():
    nets = cifar.build_cifar_models([1, 2], cifar.CifarConfig(**TINY), device="cpu")
    params, buffers = stack_params(nets)
    name = "Conv_0.weight"
    assert torch.equal(params[name][1], nets[1].state_dict()[name])
    back = unstack_params((params, buffers), 2)
    assert len(back) == 2 and torch.equal(back[0][0][name], nets[0].state_dict()[name])
    with pytest.raises(ValueError, match="mode"):
        from superdiff_tpu_torch.models.ensemble import make_stacked_score_fn

        make_stacked_score_fn(nets, mode="pmap")
