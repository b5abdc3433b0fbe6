"""The port's NCSN normalizers and RefineNet blocks against the JAX
package's, fp32 on the CPU, with Flax params carried across
(``models/from_jax.py::ncsn_from_flax``); and the model registry's names.

Inputs are NHWC for JAX and NCHW for the port, at odd and non-square
spatial sizes (7 x 5); the fusions grow (4 x 3 -> 7 x 5) and shrink
(7 x 5 -> 3 x 2, where ``jax.image.resize`` antialiases). Every output
must lie within 1e-5 of the largest JAX output.
"""

import functools

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params

from superdiff_tpu.models import ncsn_layers as jl
from superdiff_tpu.models import normalization as jn
from superdiff_tpu.models import registry as jreg
from superdiff_tpu_torch.models import ncsn_layers as tl
from superdiff_tpu_torch.models import normalization as tn
from superdiff_tpu_torch.models import registry as treg
from superdiff_tpu_torch.models.from_jax import ncsn_from_flax

torch.set_num_threads(2)

TOL = 1e-5
B, H, W, NCLS = 2, 7, 5, 5
Y = np.array([1, 4], np.int32)


def _x(c, h=H, w=W, seed=0):
    return np.random.default_rng(seed).standard_normal((B, h, w, c)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _check(jmod, tmod, jargs, targs, seed=0):
    params = draw_params(jmod, *jargs, seed=seed)
    ref = np.asarray(jmod.apply({"params": params}, *jargs))
    ncsn_from_flax(tmod, params)
    with torch.no_grad():
        got = tmod(*targs).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _jcond():
    return functools.partial(jn.ConditionalInstanceNorm2dPlus, num_classes=NCLS)


def _tcond():
    return functools.partial(tn.ConditionalInstanceNorm2dPlus, num_classes=NCLS)


@pytest.mark.parametrize("name,kw", [
    ("VarianceNorm2d", {}), ("VarianceNorm2d", {"bias": True}),
    ("InstanceNorm2d", {}), ("InstanceNorm2d", {"bias": False}),
    ("InstanceNorm2dPlus", {}), ("InstanceNorm2dPlus", {"bias": False}),
])
def test_norm_matches_jax(name, kw):
    x = _x(6) * 3.0 + 1.5
    _check(getattr(jn, name)(**kw), getattr(tn, name)(6, **kw), (jnp.asarray(x),), (_nchw(x),))


@pytest.mark.parametrize("bias", [True, False])
def test_conditional_instance_norm_matches_jax(bias):
    x = _x(6) * 2.0 - 0.5
    _check(jn.ConditionalInstanceNorm2dPlus(num_classes=NCLS, bias=bias),
           tn.ConditionalInstanceNorm2dPlus(6, num_classes=NCLS, bias=bias),
           (jnp.asarray(x), jnp.asarray(Y)), (_nchw(x), torch.from_numpy(Y).long()))


@pytest.mark.parametrize("name", ["GroupNorm", "VarianceNorm", "InstanceNorm", "InstanceNorm++"])
def test_get_normalization_matches_jax(name):
    x = _x(8)
    _check(jn.get_normalization(name)(), tn.get_normalization(name)(8),
           (jnp.asarray(x),), (_nchw(x),))


def test_get_normalization_conditional_and_unknown():
    x = _x(4)
    _check(jn.get_normalization("InstanceNorm++", True, NCLS)(),
           tn.get_normalization("InstanceNorm++", True, NCLS)(4),
           (jnp.asarray(x), jnp.asarray(Y)), (_nchw(x), torch.from_numpy(Y).long()))
    with pytest.raises(NotImplementedError):
        tn.get_normalization("GroupNorm", conditional=True)
    with pytest.raises(ValueError):
        tn.get_normalization("BatchNorm")


class _JConv(fnn.Module):
    features: int
    stride: int = 1
    dilation: int = 1

    @fnn.compact
    def __call__(self, x):
        return jl.ncsn_conv3x3(x, self.features, stride=self.stride, dilation=self.dilation)


class _TConv(torch.nn.Module):
    def __init__(self, c_in, features, stride=1, dilation=1):
        super().__init__()
        self.Conv_0 = tl.ncsn_conv3x3(c_in, features, stride=stride, dilation=dilation)

    def forward(self, x):
        return self.Conv_0(x)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_ncsn_conv3x3_same_padding_matches_jax(stride, dilation):
    x = _x(3)
    _check(_JConv(4, stride, dilation), _TConv(3, 4, stride, dilation),
           (jnp.asarray(x),), (_nchw(x),))


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
def test_crp_block_matches_jax(cond):
    x = _x(6)
    if cond:
        _check(jl.CondCRPBlock(features=6, normalizer=_jcond()),
               tl.CondCRPBlock(6, _tcond()),
               (jnp.asarray(x), jnp.asarray(Y)), (_nchw(x), torch.from_numpy(Y).long()))
    else:
        _check(jl.CRPBlock(features=6), tl.CRPBlock(6), (jnp.asarray(x),), (_nchw(x),))


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
def test_rcu_block_matches_jax(cond):
    x = _x(6)
    if cond:
        _check(jl.CondRCUBlock(features=6, normalizer=_jcond(), n_blocks=2, n_stages=2),
               tl.CondRCUBlock(6, _tcond(), n_blocks=2, n_stages=2),
               (jnp.asarray(x), jnp.asarray(Y)), (_nchw(x), torch.from_numpy(Y).long()))
    else:
        _check(jl.RCUBlock(features=6, n_blocks=3, n_stages=1),
               tl.RCUBlock(6, n_blocks=3, n_stages=1), (jnp.asarray(x),), (_nchw(x),))


@pytest.mark.parametrize("shape,interp", [((7, 5), "bilinear"), ((3, 2), "bilinear"),
                                          ((9, 6), "nearest_neighbor"),
                                          ((3, 2), "nearest_neighbor")],
                         ids=["grow", "shrink", "nearest-grow", "nearest-shrink"])
@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
def test_msf_block_matches_jax(cond, shape, interp):
    xs = [_x(6, seed=1), _x(4, 4, 3, seed=2)]
    jx, tx = [jnp.asarray(a) for a in xs], [_nchw(a) for a in xs]
    if cond:
        _check(jl.CondMSFBlock(shape=shape, features=5, normalizer=_jcond(),
                               interpolation=interp),
               tl.CondMSFBlock([6, 4], shape, 5, _tcond(), interpolation=interp),
               (jx, jnp.asarray(Y)), (tx, torch.from_numpy(Y).long()))
    else:
        _check(jl.MSFBlock(shape=shape, features=5, interpolation=interp),
               tl.MSFBlock([6, 4], shape, 5, interpolation=interp), (jx,), (tx,))


@pytest.mark.parametrize("start,end", [(False, False), (True, False), (False, True)],
                         ids=["middle", "start", "end"])
@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
def test_refine_block_matches_jax(cond, start, end):
    xs = [_x(6, seed=3)] if start else [_x(6, seed=3), _x(4, 4, 3, seed=4)]
    planes = [a.shape[-1] for a in xs]
    jx, tx = [jnp.asarray(a) for a in xs], [_nchw(a) for a in xs]
    if cond:
        _check(jl.CondRefineBlock(output_shape=(H, W), features=6, normalizer=_jcond(),
                                  start=start, end=end),
               tl.CondRefineBlock(planes, (H, W), 6, _tcond(), start=start, end=end),
               (jx, jnp.asarray(Y)), (tx, torch.from_numpy(Y).long()))
    else:
        _check(jl.RefineBlock(output_shape=(H, W), features=6, start=start, end=end),
               tl.RefineBlock(planes, (H, W), 6, start=start, end=end), (jx,), (tx,))


@pytest.mark.parametrize("name", ["ConvMeanPool", "MeanPoolConv"])
@pytest.mark.parametrize("kernel_size,biases", [(3, True), (2, False)])
def test_pool_conv_pairs_match_jax(name, kernel_size, biases):
    x = _x(3, 8, 6)
    _check(getattr(jl, name)(output_dim=5, kernel_size=kernel_size, biases=biases),
           getattr(tl, name)(3, 5, kernel_size=kernel_size, biases=biases),
           (jnp.asarray(x),), (_nchw(x),))


def test_registry_names_match_jax():
    from superdiff_tpu_torch.models.mlp import MLPScoreNet
    from superdiff_tpu_torch.models.protein.ipa import IPAScoreNetwork
    from superdiff_tpu_torch.models.sd.unet import SDUNet
    from superdiff_tpu_torch.models.unet import ScoreUNet

    assert set(treg.registered_models()) == set(jreg.registered_models())
    want = {"score-net": ScoreUNet, "mlp": MLPScoreNet, "sd-unet": SDUNet,
            "ipa": IPAScoreNetwork}
    for name, cls in want.items():
        assert treg.get_model(name) is cls
        assert cls.__name__ == jreg.get_model(name).__name__
    with pytest.raises(KeyError):
        treg.get_model("nope")

    @treg.register_model(name="_test_model")
    class _M(torch.nn.Module):
        pass

    try:
        assert treg.get_model("_test_model") is _M
        with pytest.raises(ValueError):
            treg.register_model(_M, name="_test_model")
    finally:
        treg._MODELS.pop("_test_model")
