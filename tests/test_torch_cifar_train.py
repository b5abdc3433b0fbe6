"""The port's CIFAR training step against the JAX package's, fp32 on the CPU.

Tiny ScoreUNet (nf 16, ch_mult (1, 2), one res block, attention at 8 px,
16 px images), dropout 0 (masks cannot be reproduced across frameworks),
batch 4, lr 1e-3 with a 2-update warmup (rates 0, lr/2, lr), grad_clip 1
(the largest gradients are clipped), EMA 0.9. Parameters are drawn non-zero
(``draw_params``): a fresh net's zero-initialised output layers would hide
the rest of it. One JAX run of three jitted steps serves every test; the
port takes JAX's threefry ``eps`` draws.

Tolerances. The loss within 1e-5 relative; the cursor bit for bit; Adam's
moments within 2e-4 of their largest magnitude (fp32 gradients of a loss of
~1e3). Parameters and EMA in units of lr: an element whose JAX gradient
stays below 1e-4 of the largest one (here the per-channel shifts ahead of a
GroupNorm with one channel per group, whose gradient is 0 but for rounding)
gets Adam's ``m / sqrt(v)`` of rounding noise, near +-1 with either sign, so
it may differ by up to 2 lr per update (share of such elements printed in
the failure message, 11 % at this size); every other element within 1e-3 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params

from superdiff_tpu.core import VPSchedule as JVPSchedule
from superdiff_tpu.core import kronecker_times as jax_kronecker
from superdiff_tpu.core import make_dsm_loss as jax_dsm_loss
from superdiff_tpu.pipelines import cifar as jcifar
from superdiff_tpu.train import init_train_state as jax_init_state
from superdiff_tpu.train import make_optimizer as jax_optimizer
from superdiff_tpu.train import make_train_step as jax_train_step
from superdiff_tpu_torch.core.dsm import kronecker_times, make_dsm_loss
from superdiff_tpu_torch.core.schedules import VPSchedule
from superdiff_tpu_torch.models.from_jax import state_dict_from_flax, train_state_from_jax
from superdiff_tpu_torch.pipelines import cifar
from superdiff_tpu_torch.train import checkpoints, init_train_state, make_optimizer, make_train_step

torch.set_num_threads(1)

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16, dropout=0.0)
LR, WARMUP, EMA, CLIP, B1 = 1e-3, 2, 0.9, 1.0, 0.9
RATES = [0.0, 0.5 * LR, LR]  # the learning rate of updates 1, 2, 3
SHAPE = (4, 16, 16, 3)


@pytest.fixture(scope="module")
def jax_run():
    """Drawn params, three batches, and the JAX states after 0..3 steps
    with the eps each step drew."""
    jmodel = jcifar.CifarConfig(**TINY).model()
    params = draw_params(jmodel, jnp.zeros((1, 1, 1, 1)), jnp.zeros((1, 16, 16, 3)), None,
                         seed=3)
    opt = jax_optimizer(LR, WARMUP, grad_clip=CLIP)
    state = jax_init_state(jax.random.PRNGKey(0), params, opt, ema_rate=EMA)
    step = jax_train_step(opt, jax_dsm_loss(jcifar._apply_fn(jmodel), JVPSchedule()))
    rng = np.random.default_rng(0)
    batches = [rng.uniform(-1, 1, SHAPE).astype(np.float32) for _ in range(3)]
    states, losses, eps = [jax.device_get(state)], [], []
    key = state.key
    for b in batches:
        key, iter_key = jax.random.split(key)
        eps.append(np.array(jax.random.normal(jax.random.split(iter_key, 3)[1], SHAPE)))
        state, loss = step(state, {"image": jnp.asarray(b)})
        states.append(jax.device_get(state))
        losses.append(float(loss))
    return dict(params=params, batches=batches, states=states, losses=losses, eps=eps)


def _adam(jax_state):
    return jax_state.opt_state[1][0]


def _port_state(params):
    net = cifar.CifarConfig(**TINY).model()
    net.load_state_dict(state_dict_from_flax(params))
    opt = make_optimizer(LR, WARMUP, grad_clip=CLIP)
    state = init_train_state(torch.Generator().manual_seed(0), net, opt, ema_rate=EMA)
    step = make_train_step(opt, make_dsm_loss(cifar._apply_fn(net), VPSchedule()))
    return state, step


def _noise_elements(run, upto):
    """Per parameter, the elements whose JAX gradient stayed below 1e-4 of
    the largest gradient over steps 1..upto (from Adam's first moments)."""
    mus = [state_dict_from_flax(_adam(s).mu) for s in run["states"][:upto + 1]]
    grads = [{n: (mus[k][n] - B1 * mus[k - 1][n]) / (1 - B1) for n in mus[0]}
             for k in range(1, upto + 1)]
    largest = max(g[n].abs().max().item() for g in grads for n in g)
    return {n: torch.stack([g[n].abs() for g in grads]).amax(0) <= 1e-4 * largest
            for n in mus[0]}


def _within_lr_units(got, ref, noise, lrs, what):
    """|got - ref| <= 2 sum(lrs) on the noise elements, <= 1e-3 lr else."""
    rest, loose = [], []
    for n, r in ref.items():
        d = (got[n].detach() - r).abs()
        rest.append(d[~noise[n]])
        loose.append(d[noise[n]])
    rest, loose = torch.cat(rest), torch.cat(loose)
    share = loose.numel() / (rest.numel() + loose.numel())
    msg = (f"{what}: max |diff| {rest.max().item() / LR:.3g} lr on the elements with a "
           f"gradient, {loose.max().item() / LR:.3g} lr on the {share:.1%} whose gradient "
           f"is rounding noise")
    assert rest.max().item() <= 1e-3 * LR, msg
    assert loose.max().item() <= 2 * sum(lrs) + 1e-7, msg


@pytest.mark.parametrize("u0,shards", [(0.5, 1), (0.913, 1), (0.25, 2)])
def test_kronecker_times_bit_for_bit(u0, shards):
    ju0 = jnp.asarray(u0, jnp.float32)
    tu0 = torch.tensor(u0, dtype=torch.float32)
    for index in range(shards):
        jt, jn = jax_kronecker(8, ju0, 1e-3, 1.0, num_shards=shards, shard_index=index)
        t, n = kronecker_times(8, tu0, 1e-3, 1.0, num_shards=shards, shard_index=index)
        assert t.dtype == n.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_dsm_loss_matches_jax(jax_run):
    jstate = jax_run["states"][0]
    state, _ = _port_state(jax_run["params"])
    loss_fn = make_dsm_loss(cifar._apply_fn(state.model), VPSchedule())
    with torch.no_grad():
        loss, cursor = loss_fn(torch.tensor(0.5), {"image": torch.from_numpy(jax_run["batches"][0])},
                               eps=torch.from_numpy(jax_run["eps"][0]))
    np.testing.assert_allclose(loss.item(), jax_run["losses"][0], rtol=1e-5)
    assert cursor.numpy().tobytes() == np.asarray(jax_run["states"][1].sampler_state,
                                                  np.float32).tobytes()
    assert float(jstate.sampler_state) == 0.5


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(jax_run, steps):
    state, step = _port_state(jax_run["params"])
    before = {n: p.detach().clone() for n, p in state.params.items()}
    for i in range(steps):
        state, loss = step(state, {"image": torch.from_numpy(jax_run["batches"][i])},
                           eps=torch.from_numpy(jax_run["eps"][i]))
        np.testing.assert_allclose(loss.item(), jax_run["losses"][i], rtol=1e-5)
        if i == 0:  # the warmup's first update has learning rate 0
            assert all(torch.equal(p, before[n]) for n, p in state.params.items())
    ref = jax_run["states"][steps]
    assert state.step == int(ref.step) == steps + 1
    assert state.sampler_state.numpy().tobytes() == np.asarray(ref.sampler_state,
                                                               np.float32).tobytes()
    noise = _noise_elements(jax_run, steps)
    _within_lr_units(state.params, state_dict_from_flax(ref.params), noise, RATES[:steps],
                     "params")
    _within_lr_units(state.params_ema, state_dict_from_flax(ref.params_ema), noise,
                     RATES[:steps], "params_ema")
    for key, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        ref_m = state_dict_from_flax(getattr(_adam(ref), leaf))
        scale = max(v.abs().max().item() for v in ref_m.values())
        worst = max((state.optimizer.state[p][key] - ref_m[n]).abs().max().item()
                    for n, p in state.params.items())
        assert worst <= 2e-4 * scale, (key, worst / scale)
        assert all(state.optimizer.state[p]["step"].item() == steps for p in state.params.values())
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(min(steps / WARMUP, 1.0) * LR)


def test_jax_params_unchanged_by_first_step(jax_run):
    p0 = state_dict_from_flax(jax_run["params"])
    p1 = state_dict_from_flax(jax_run["states"][1].params)
    assert all(torch.equal(p1[n], p0[n]) for n in p0)


def test_clip_is_elementwise(jax_run):
    """Adam's first moment after one step is 0.1 * clip(g, -c, c) element by
    element (optax.clip), not a global-norm rescale: with c below most
    gradients, the clipped ones sit at +-0.1 c and the rest keep their value."""
    clip = 1e-3
    state, _ = _port_state(jax_run["params"])
    net = state.model
    opt = make_optimizer(LR, WARMUP, grad_clip=clip)
    state = init_train_state(torch.Generator().manual_seed(0), net, opt, ema_rate=EMA)
    loss_fn = make_dsm_loss(cifar._apply_fn(net), VPSchedule())
    batch = {"image": torch.from_numpy(jax_run["batches"][0])}
    eps = torch.from_numpy(jax_run["eps"][0])
    loss, _ = loss_fn(torch.tensor(0.5), batch, eps=eps)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    make_train_step(opt, loss_fn)(state, batch, eps=eps)
    at_bound = inside = 0
    for p, g in zip(net.parameters(), grads):
        m = state.optimizer.state[p]["exp_avg"]
        torch.testing.assert_close(m, 0.1 * g.clamp(-clip, clip), rtol=1e-6, atol=0)
        at_bound += int((g.abs() > clip).sum())
        inside += int(((g != 0) & (g.abs() < clip)).sum())
    assert at_bound > 0 and inside > 0


def test_carried_jax_state_steps_once(jax_run):
    """A JAX TrainState after two updates (Adam count 2, non-zero moments),
    carried across and stepped once on each side."""
    mid, ref = jax_run["states"][2], jax_run["states"][3]
    state, step = _port_state(jax_run["params"])
    train_state_from_jax(mid, state)
    assert state.step == 3 and state.optimizer.param_groups[0]["lr"] == pytest.approx(LR)
    for n, p in state.params.items():
        assert torch.equal(p.detach(), state_dict_from_flax(mid.params)[n])
        assert torch.equal(state.optimizer.state[p]["exp_avg"],
                           state_dict_from_flax(_adam(mid).mu)[n])
    state, loss = step(state, {"image": torch.from_numpy(jax_run["batches"][2])},
                       eps=torch.from_numpy(jax_run["eps"][2]))
    np.testing.assert_allclose(loss.item(), jax_run["losses"][2], rtol=1e-5)
    assert state.step == int(ref.step) == 4
    assert state.sampler_state.numpy().tobytes() == np.asarray(ref.sampler_state,
                                                               np.float32).tobytes()
    noise = _noise_elements(jax_run, 3)
    _within_lr_units(state.params, state_dict_from_flax(ref.params), noise, RATES[2:],
                     "params")
    _within_lr_units(state.params_ema, state_dict_from_flax(ref.params_ema), noise,
                     RATES[2:], "params_ema")


def _dropout_run(params, batches, steps, workdir=None, resume_at=None):
    """The port alone, dropout 0.1 and eps drawn from the state's generator:
    ``steps`` steps, or ``resume_at`` steps, a checkpoint, a fresh state
    restored from it, and the rest."""
    cfg = cifar.CifarConfig(**{**TINY, "dropout": 0.1})

    def fresh():
        net = cfg.model()
        net.load_state_dict(state_dict_from_flax(params))
        opt = make_optimizer(LR, WARMUP, grad_clip=CLIP)
        state = init_train_state(torch.Generator().manual_seed(7), net, opt, ema_rate=EMA)
        return state, make_train_step(opt, make_dsm_loss(cifar._apply_fn(net), VPSchedule()))

    state, step = fresh()
    for i in range(steps):
        if i == resume_at:
            mgr = checkpoints.make_manager(workdir)
            checkpoints.save(mgr, i, state)
            state, step = fresh()
            assert checkpoints.restore_latest(mgr, state) is state
        state, _ = step(state, {"image": torch.from_numpy(batches[i % len(batches)])})
    return state


def test_resume_is_bit_exact(jax_run, tmp_path):
    """3 steps, save, restore into a fresh state, 3 steps == 6 straight
    steps, bit for bit: parameters, EMA, Adam state, cursor, generator."""
    straight = _dropout_run(jax_run["params"], jax_run["batches"], 6)
    resumed = _dropout_run(jax_run["params"], jax_run["batches"], 6, str(tmp_path), resume_at=3)
    assert straight.step == resumed.step == 7
    for n, p in straight.params.items():
        assert torch.equal(p, resumed.params[n]), n
        assert torch.equal(straight.params_ema[n], resumed.params_ema[n]), n
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(straight.optimizer.state[p][key],
                               resumed.optimizer.state[resumed.params[n]][key]), (n, key)
    assert torch.equal(straight.sampler_state, resumed.sampler_state)
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())
    assert straight.schedule.state_dict() == resumed.schedule.state_dict()


def test_checkpoints_keep_the_newest(jax_run, tmp_path):
    state, _ = _port_state(jax_run["params"])
    mgr = checkpoints.make_manager(str(tmp_path), max_to_keep=2)
    for step in (5, 10, 15):
        state.step = step + 1
        checkpoints.save(mgr, step, state)
    assert mgr.all_steps() == [10, 15]
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "chkpt_10.pt", "chkpt_15.pt"]
    fresh, _ = _port_state(jax_run["params"])
    assert checkpoints.restore_latest(mgr, fresh).step == 16
    assert checkpoints.restore_latest(checkpoints.make_manager(str(tmp_path / "none")),
                                      fresh) is None
