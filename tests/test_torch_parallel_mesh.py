"""The port's process topology, mesh and data-parallel training
(``superdiff_tpu_torch/parallel/{distributed,mesh}.py``,
``train/trainer.py::make_train_step(mesh=...)``) on gloo worlds of CPU
processes, against the JAX package.

* Topology (world 2, one rank a "host"): what JAX's two-process child
  prints (``tests/_multihost_child.py``): process count and index, the
  coordinator, the ('dcn', 'data', 'model') mesh, a mean over the data
  axes that needs both ranks' rows, and the host-sharded Kronecker times
  tiling JAX's global sequence, bit for bit.
* DP training against JAX: the MLP score net of JAX's multi-host test
  (hidden (32, 32), drawn non-zero weights, batch 16 of 2-D points, three
  steps, lr 1e-3 with a 2-update warmup, grad_clip 1, EMA 0.9, JAX's
  threefry eps) at world 2 against JAX's ``make_train_step(mesh=
  make_mesh(data=2))``: the loss within 1e-5 relative, the cursor bit for
  bit, parameters and EMA within 5e-3 lr on the elements whose Adam first
  moment is above 1e-4 of the largest and 2 lr an update on the rest
  (rounding noise, which Adam's ``m / sqrt(v)`` scales to near +-1). The
  two ranks' gradients are summed in another order than one process's,
  and Adam divides that rounding by the gradient: on the tiny ScoreUNet
  1.4e-6 of the largest gradient, up to 1.2e-3 of an element whose
  gradient is small at one step, 1.14e-3 lr against JAX at world 2
  (measured). The state is bit-identical across the ranks; world 2 against
  world 1 (the same step without a process group) to the same tolerances.
* The tiny ScoreUNet (nf 16, 16 px, batch 4) with dropout 0.1 and the
  step's own draws (eps and masks from the state's generator): world 2
  against world 1, the same tolerances, since every rank draws the global
  batch's numbers and keeps its rows; the state bit-identical across ranks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import World
from torch_parity import draw_params
import torch_parallel_cases as cases

from superdiff_tpu.core import VPSchedule as JVPSchedule
from superdiff_tpu.core import kronecker_times as jax_kronecker
from superdiff_tpu.core import make_dsm_loss as jax_dsm_loss
from superdiff_tpu.parallel import make_mesh as jax_make_mesh
from superdiff_tpu.models.mlp import MLPScoreNet as JaxMLP
from superdiff_tpu.train import init_train_state as jax_init_state
from superdiff_tpu.train import make_optimizer as jax_optimizer
from superdiff_tpu.train import make_train_step as jax_train_step
from superdiff_tpu_torch.models.from_jax import state_dict_from_flax
from superdiff_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16, dropout=0.1)
HIDDEN = (32, 32)
LR, WARMUP, EMA, CLIP = 1e-3, 2, 0.9, 1.0
RATES = [0.0, 0.5 * LR, LR]
SHAPE = (16, 2)


def _mlp_draws():
    """Drawn MLP params, three batches and the eps JAX's steps draw from
    ``PRNGKey(0)`` (regenerated from the same keys)."""
    jmodel = JaxMLP(hidden=HIDDEN, out_dim=2)
    params = draw_params(jmodel, jnp.zeros((1, 1)), jnp.zeros((1, 2)), seed=3)
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(3)]
    eps, key = [], jax.random.PRNGKey(0)
    for _ in batches:
        key, iter_key = jax.random.split(key)
        eps.append(np.array(jax.random.normal(jax.random.split(iter_key, 3)[1], SHAPE)))
    return jmodel, dict(params=params, batches=batches, eps=eps)


def _dp_inputs(params, batches, eps=None, **net):
    return dict(params=params, lr=LR, warmup=WARMUP, clip=CLIP, ema=EMA, seed=0,
                batches=[torch.from_numpy(b) for b in batches],
                eps=None if eps is None else [torch.from_numpy(e) for e in eps], **net)


def _unet_inputs():
    """The tiny ScoreUNet's drawn weights (the port's Flax-like init, then
    every parameter redrawn non-zero) and two batches, for DP with dropout."""
    from superdiff_tpu_torch.pipelines import cifar

    net = cifar.CifarConfig(**TINY).model()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / max(p[0].numel(), 1) ** 0.5)
    rng = np.random.default_rng(1)
    batches = [rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    return _dp_inputs(net.state_dict(), batches, cfg=TINY)


@pytest.fixture(scope="module")
def runs():
    """World 2 (topology, DP of the MLP with JAX's eps, DP of the ScoreUNet
    with dropout and the step's own draws) and world 1 (the same DP runs,
    one process, no process group); JAX's mesh step meanwhile."""
    jmodel, run = _mlp_draws()
    mlp = _dp_inputs(state_dict_from_flax(run["params"]), run["batches"], run["eps"],
                     mlp=HIDDEN)
    drop = _unet_inputs()
    two = World(2, {"topology": {"address": "unused:0"}, "dp_train": mlp,
                    "dp_train:dropout": drop}, env={"LOCAL_WORLD_SIZE": "1"})
    one = {"dp_train": cases.dp_train(mlp), "dp_train:dropout": cases.dp_train(drop)}

    def apply_fn(p, t, x, y, rng=None):
        return jmodel.apply({"params": p}, t, x)

    opt = jax_optimizer(LR, WARMUP, grad_clip=CLIP)
    state = jax_init_state(jax.random.PRNGKey(0), run["params"], opt, ema_rate=EMA)
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    step = jax_train_step(opt, jax_dsm_loss(apply_fn, JVPSchedule()), mesh=mesh)
    losses = []
    for b in run["batches"]:
        state, loss = step(state, {"image": jnp.asarray(b)})
        losses.append(float(loss))
    run.update(state=jax.device_get(state), losses=losses)
    return run, two.join(), one


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[1], runs[2]


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs[0]


def test_process_topology(worlds):
    two, _ = worlds
    for r, out in enumerate(two):
        got = out["topology"]
        assert (got["rank"], got["world"]) == (r, 2)
        assert got["is_coordinator"] == (r == 0)
        assert got["shard_info"] == (2, r) and got["data_sharding"] == (2, r)
        assert got["mesh_axes"] == {"dcn": 2, "data": 1, "model": 1}
        assert got["coords"] == {"dcn": r, "data": 0, "model": 0}
        # a mean over 16 rows split 8/8: 7.5 only if the reduction ran
        np.testing.assert_allclose(got["global_mean"], 7.5, rtol=1e-6)


def test_kronecker_host_sharding_matches_jax(worlds):
    two, _ = worlds
    jt, _ = jax_kronecker(8, jnp.asarray(0.5, jnp.float32), 0.0, 1.0)
    expect = (0.5 + math.sqrt(2.0) * np.arange(8)) % 1.0
    for out in two:
        got = np.asarray(out["topology"]["kronecker_all"], np.float32)
        np.testing.assert_array_equal(got, np.asarray(jt))
        np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_one_rank_mesh_without_process_group():
    mesh = M.make_mesh()
    assert dict(mesh.shape) == {"data": 1, "model": 1} and not mesh.distributed
    x = torch.arange(6.0)
    assert mesh.all_reduce(x, "data") is x and torch.equal(mesh.all_gather(x, "model"), x)
    assert torch.equal(M.shard_batch({"image": x}, mesh)["image"], x)
    assert M.ensemble_sharding(mesh, 2) == slice(0, 2)
    with pytest.raises(ValueError, match="ranks"):
        M.make_mesh(data=2)


def _lr_units(got, ref, mu, what):
    """|got - ref| <= 5e-3 lr where Adam's first moment is above 1e-4 of
    its largest, <= 2 lr an update elsewhere."""
    largest = max(m.abs().max().item() for m in mu.values())
    for n, r in ref.items():
        d = (got[n] - r).abs()
        noise = mu[n].abs() <= 1e-4 * largest
        assert d[~noise].max().item() <= 5e-3 * LR if (~noise).any() else True, (what, n)
        assert d.max().item() <= 2 * sum(RATES) + 1e-7, (what, n)


def _mu(out):
    names = list(out["params"])
    return {n: m for n, (m, _) in zip(names, out["adam"])}


def test_dp_step_matches_jax_mesh_step(worlds, jax_run):
    two, _ = worlds
    ref = {k: v for k, v in state_dict_from_flax(jax_run["state"].params).items()}
    ema = state_dict_from_flax(jax_run["state"].params_ema)
    mu = state_dict_from_flax(jax_run["state"].opt_state[1][0].mu)
    for out in two:
        got = out["dp_train"]
        np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=1e-5)
        assert got["step"] == int(jax_run["state"].step) == 4
        assert got["sampler_state"].numpy().tobytes() == np.asarray(
            jax_run["state"].sampler_state, np.float32).tobytes()
        _lr_units(got["params"], ref, mu, "params")
        _lr_units(got["ema"], ema, mu, "ema")


@pytest.mark.parametrize("case", ["dp_train", "dp_train:dropout"])
def test_dp_state_bit_identical_across_ranks(worlds, case):
    two, _ = worlds
    a, b = two[0][case], two[1][case]
    assert a["losses"] == b["losses"] and a["step"] == b["step"]
    for key in ("params", "ema"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])
    assert all(torch.equal(x, y) for pa, pb in zip(a["adam"], b["adam"]) for x, y in zip(pa, pb))
    assert torch.equal(a["rng"], b["rng"])
    assert torch.equal(a["sampler_state"], b["sampler_state"])


@pytest.mark.parametrize("case", ["dp_train", "dp_train:dropout"])
def test_dp_world_two_matches_world_one(worlds, case):
    two, one = worlds
    got, ref = two[0][case], one[case]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert got["sampler_state"].item() == ref["sampler_state"].item()
    assert torch.equal(got["rng"], ref["rng"])  # the same draws, sliced
    _lr_units(got["params"], ref["params"], _mu(ref), case)
    _lr_units(got["ema"], ref["ema"], _mu(ref), case)
