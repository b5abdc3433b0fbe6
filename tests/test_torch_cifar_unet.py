"""Port CIFAR ScoreUNet vs the JAX ScoreUNet at the tiny config, fp32 on the CPU.

Tiny config: nf 16, ch_mult (1, 2), one res block, attention at 8 px, 16 px
images (so the stride-2 ``"SAME"`` downsample, the nearest upsample and both
attention placements run). Weights are drawn non-zero (``draw_params``): a
net fresh from Flax's ``model.init`` outputs exactly 0 (its output conv,
each resnet's second conv and each attention output are zero-initialised),
which would hide any layer error. Tolerance: 1e-5 of the output's largest
magnitude (sums are taken in other orders by XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, draw_params, t

from superdiff_tpu.models.convert_cifar import convert_scorenet_params as jax_convert
from superdiff_tpu.models.unet import timestep_embedding as jax_temb
from superdiff_tpu.pipelines import cifar as jcifar
from superdiff_tpu_torch.models.convert_cifar import convert_scorenet_params
from superdiff_tpu_torch.models.from_jax import init_like_flax_, state_dict_from_flax
from superdiff_tpu_torch.models.unet import timestep_embedding
from superdiff_tpu_torch.pipelines import cifar

torch.set_num_threads(1)

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16)


def _example(conditioned):
    y = jnp.zeros((1,), jnp.int32) if conditioned else None
    return jnp.zeros((1, 1, 1, 1)), jnp.zeros((1, 16, 16, 3)), y


@pytest.mark.parametrize("conditioned", [False, True])
def test_score_unet_matches_jax(conditioned):
    jmodel = jcifar.CifarConfig(conditioned=conditioned, **TINY).model()
    params = draw_params(jmodel, *_example(conditioned), seed=int(conditioned))
    net = carry(cifar.CifarConfig(conditioned=conditioned, **TINY).model(), params)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    tt = np.array([0.9, 0.31, 0.02], np.float32).reshape(3, 1, 1, 1)
    y = np.array([0, 3, 9], np.int32) if conditioned else None
    ref = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, tt, x, y))(params))
    with torch.no_grad():
        got = net(t(tt), t(x), None if y is None else t(y)).numpy()
    assert got.shape == ref.shape == (3, 16, 16, 3) and got.dtype == np.float32
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-5)


def test_flax_zero_init_layers_are_zero_in_the_port():
    jmodel = jcifar.CifarConfig(**TINY).model()
    flax = jax.jit(lambda k: jmodel.init(k, *_example(False)))(jax.random.PRNGKey(0))
    flax_sd = state_dict_from_flax(jax.device_get(flax["params"]))
    net = init_like_flax_(cifar.CifarConfig(**TINY).model(), torch.Generator().manual_seed(0))
    port_sd = net.state_dict()
    assert set(port_sd) == set(flax_sd)
    zero = lambda sd: {k for k, v in sd.items() if v.ndim > 1 and not v.any()}  # noqa: E731
    assert zero(port_sd) == zero(flax_sd)
    assert {k.split(".")[-2] for k in zero(port_sd)} == {"Conv_1", "Dense_3"}
    with torch.no_grad():
        out = net(torch.tensor(0.5), torch.randn(2, 16, 16, 3))
    assert not out.any()


def _to_reference_layout(tree, in_resnet=False, in_attn=False):
    """ScoreUNet layout -> the reference ScoreNet's (the inverse rewrite)."""
    out = {}
    for key, val in tree.items():
        if key.startswith("GroupNorm32_"):
            out[key.replace("GroupNorm32_", "GroupNorm_")] = dict(val["GroupNorm_0"])
        elif key.startswith("ResnetBlock_"):
            out[key.replace("ResnetBlock_", "ResnetBlockDDPM_")] = _to_reference_layout(
                val, in_resnet=True)
        elif key.startswith("AttnBlock_"):
            out[key] = _to_reference_layout(val, in_attn=True)
        elif key.startswith("Dense_") and (in_attn or (in_resnet and key == "Dense_1")):
            idx = int(key.split("_")[1]) - (1 if in_resnet else 0)
            out[f"NIN_{idx}"] = {"W": val["kernel"], "b": val["bias"]}
        elif isinstance(val, dict):
            out[key] = _to_reference_layout(val, in_resnet, in_attn)
        else:
            out[key] = val
    return out


def test_convert_scorenet_params_matches_jax():
    jmodel = jcifar.CifarConfig(conditioned=True, **TINY).model()
    params = jax.tree.map(np.asarray, draw_params(jmodel, *_example(True), seed=2))
    ref_layout = _to_reference_layout(params)
    assert "NIN_0" in ref_layout["ResnetBlockDDPM_1"] and "NIN_3" in ref_layout["AttnBlock_0"]
    got, want = convert_scorenet_params(ref_layout), jax_convert(ref_layout)
    flat = lambda tr: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                       for p, v in jax.tree_util.tree_flatten_with_path(tr)[0]}
    got_flat, want_flat, orig = flat(got), flat(want), flat(params)
    assert set(got_flat) == set(want_flat) == set(orig)
    for k in orig:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
        np.testing.assert_array_equal(got_flat[k], orig[k], err_msg=k)
    # the converted tree loads strictly through build_cifar_models' state_dict path
    sd = state_dict_from_flax(got)
    (net,) = cifar.build_cifar_models([sd], cifar.CifarConfig(conditioned=True, **TINY), "cpu")
    assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())


def test_timestep_embedding_matches_jax():
    ts = np.array([0.0, 1e-3, 0.5, 1.0], np.float32)
    for dim in (16, 17):
        ref = np.asarray(jax_temb(jnp.asarray(ts), dim))
        got = timestep_embedding(t(ts), dim).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
