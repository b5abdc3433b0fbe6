"""The port's ScoreUNet options (dropout, conv-free resampling) and its
MLPScoreNet against the JAX modules, fp32 on the CPU; two MLPs trained by
the port and OR-composed.

Weights are drawn non-zero (``draw_params``). Forward tolerance: 1e-5 of the
output's largest magnitude, as ``test_torch_cifar_unet.py`` (sums in other
orders). Dropout masks cannot be reproduced across frameworks: rate 0 in
``train()`` mode is held to JAX's ``train=True``, and active dropout to its
own properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, draw_params, t

from superdiff_tpu.models.mlp import MLPScoreNet as JaxMLP
from superdiff_tpu.models.unet import ScoreUNet as JaxScoreUNet
from superdiff_tpu_torch.core.dsm import make_dsm_loss
from superdiff_tpu_torch.core.schedules import VPSchedule
from superdiff_tpu_torch.core.superpose import SuperposeConfig, stack_score_fns, superpose
from superdiff_tpu_torch.models.from_jax import init_like_flax_
from superdiff_tpu_torch.models.mlp import MLPScoreNet
from superdiff_tpu_torch.models.unet import Dropout, ScoreUNet
from superdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step

torch.set_num_threads(1)

ARCH = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,))


def _close(got, ref):
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("resamp_with_conv,train", [(False, False), (True, True),
                                                    (False, True)])
def test_score_unet_options_match_jax(resamp_with_conv, train):
    """``resamp_with_conv=False`` (2x2 average pool down, nearest up, no
    convs), and ``train()`` mode at dropout 0 against Flax's ``train=True``."""
    jmodel = JaxScoreUNet(dropout=0.0, resamp_with_conv=resamp_with_conv, **ARCH)
    example = (jnp.zeros((1, 1, 1, 1)), jnp.zeros((1, 16, 16, 3)))
    params = draw_params(jmodel, *example, seed=4)
    net = carry(ScoreUNet(dropout=0.0, resamp_with_conv=resamp_with_conv, image_size=16,
                          **ARCH), params)
    if not resamp_with_conv:
        assert not any(k.startswith(("Downsample", "Upsample")) for k in net.state_dict())
    net.train(train)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    tt = np.array([0.8, 0.4, 0.05], np.float32).reshape(3, 1, 1, 1)
    rngs = {"dropout": jax.random.PRNGKey(1)} if train else None
    ref = np.asarray(jmodel.apply({"params": params}, tt, x, None, train=train, rngs=rngs))
    with torch.no_grad():
        got = net(t(tt), t(x)).numpy()
    _close(got, ref)


def test_dropout_properties():
    p = 0.3
    drop = Dropout(p)
    x = torch.rand(64, 32, 16, 16) + 0.5  # no zeros of its own
    g = torch.Generator().manual_seed(0)
    y = drop(x, g)
    zeroed = (y == 0).float().mean().item()
    n = x.numel()
    assert abs(zeroed - p) < 5 * (p * (1 - p) / n) ** 0.5, zeroed
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / (1 - p))
    assert torch.equal(drop(x, torch.Generator().manual_seed(0)), y)  # the generator decides
    assert not torch.equal(drop(x, g), y)
    drop.eval()
    assert drop(x, g) is x
    assert Dropout(0.0)(x) is x
    half = x.to(torch.bfloat16)
    assert Dropout(p)(half, torch.Generator().manual_seed(0)).dtype == torch.bfloat16


def test_score_unet_dropout_in_train_mode_only():
    net = init_like_flax_(ScoreUNet(dropout=0.5, image_size=16, **ARCH),
                          torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-zero output layers, so dropout shows in the output
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    x, tt = torch.randn(2, 16, 16, 3), torch.tensor([0.3, 0.7]).reshape(2, 1, 1, 1)
    with torch.no_grad():
        net.eval()
        a, b = net(tt, x), net(tt, x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b)
        net.train()
        c = net(tt, x, generator=torch.Generator().manual_seed(1))
        d = net(tt, x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(c, d) and not torch.allclose(c, a)


def test_mlp_score_net_matches_jax():
    jmodel = JaxMLP(hidden=(32, 32), out_dim=2)
    params = draw_params(jmodel, jnp.zeros((1, 1)), jnp.zeros((1, 2)), seed=2)
    net = carry(MLPScoreNet(hidden=(32, 32), out_dim=2), params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 2)).astype(np.float32)
    for tt in (np.float32(0.37), np.linspace(0.1, 0.9, 5, dtype=np.float32).reshape(5, 1)):
        ref = np.asarray(jmodel.apply({"params": params}, tt, x))
        with torch.no_grad():
            _close(net(t(tt), t(x)).numpy(), ref)
    fresh = init_like_flax_(MLPScoreNet(hidden=(32, 32)), torch.Generator().manual_seed(0))
    assert not fresh(torch.tensor(0.5), torch.randn(3, 2)).any()  # zero-initialised output


def _train_mlp(mu, seed, n_iters=1500):
    """The JAX test's toy run (``tests/test_train.py``): hidden (128, 128),
    lr 2e-3, warmup 50, EMA 0.99, batch 256 of N(mu, 0.25^2)."""
    gen = torch.Generator().manual_seed(seed)
    net = init_like_flax_(MLPScoreNet(hidden=(128, 128), out_dim=2), gen)
    opt = make_optimizer(lr=2e-3, warmup=50)
    state = init_train_state(gen, net, opt, ema_rate=0.99)
    loss_fn = make_dsm_loss(lambda tt, x, y, g: net(tt, x), VPSchedule(), t_0=1e-3)
    step = make_train_step(opt, loss_fn)
    data_gen = torch.Generator().manual_seed(seed + 100)
    mu = torch.tensor(mu)
    for _ in range(n_iters):
        state, _ = step(state, {"image": mu + 0.25 * torch.randn(256, 2, generator=data_gen)})
    return net.eval().requires_grad_(False)


def test_two_trained_mlps_superpose_or():
    """Two MLPs trained on N((2, 2)) and N((-2, -2)), OR-composed over the
    VP-SDE: the samples land near either mode, both modes are covered, and
    each sample's OR weights commit to one model."""
    a, b = _train_mlp([2.0, 2.0], 0), _train_mlp([-2.0, -2.0], 1)
    score_fn = stack_score_fns([lambda tt, x: a(tt, x), lambda tt, x: b(tt, x)])
    x1 = torch.randn(128, 2, generator=torch.Generator().manual_seed(7))
    x0, logq, _ = superpose(x1, score_fn, VPSchedule(), SuperposeConfig(n_steps=400), 2,
                            generator=torch.Generator().manual_seed(8))
    d_a = (x0 - torch.tensor([2.0, 2.0])).norm(dim=-1)
    d_b = (x0 + torch.tensor([2.0, 2.0])).norm(dim=-1)
    assert (torch.minimum(d_a, d_b) < 1.5).float().mean() > 0.9
    frac_a = (d_a < d_b).float().mean().item()
    assert 0.15 < frac_a < 0.85, frac_a
    w = torch.softmax(1e6 * logq, dim=-1)
    assert torch.all(w.max(-1).values > 0.999)
