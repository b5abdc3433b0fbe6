"""The GPipe schedule (``superdiff_tpu_torch/parallel/pp.py``) on a gloo
world of 4 CPU processes, one stage a rank, against the JAX package's
``pipeline`` (on 4 of the conftest's virtual devices) and the sequential
stage stack.

Values and gradients, with JAX's ``tests/test_pp.py`` tolerances: outputs
within rtol / atol 1e-5 (the stages see the same rows; sums in other
orders), gradients of ``sum(out^2)`` with respect to the stacked
parameters and the input within 1e-4 absolute. The FrameDiff
seq-transformer trunk (``TorchTransformerLayer``, d 16, 4 heads, length
6) is pipelined one layer a rank, its values within 1e-5 of JAX's
pipeline and its gradients within 1e-4 of the port's sequential stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_dist import World

from superdiff_tpu.models.protein.framediff import TorchTransformerLayer as JaxLayer
from superdiff_tpu.parallel.pp import pipeline as jax_pipeline
from superdiff_tpu_torch.models.protein.framediff import TorchTransformerLayer

torch.set_num_threads(1)

N = 4


def _mesh():
    return Mesh(np.asarray(jax.devices()[:N]), ("pp",))


def _stage(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _stack(seed, d):
    rng = np.random.default_rng(seed)
    return {"w": (0.3 * rng.standard_normal((N, d, d))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((N, d))).astype(np.float32)}


def _seq(params, x):
    for i in range(N):
        x = _stage(jax.tree.map(lambda a: a[i], params), x)
    return x


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


MLP = {
    "values": dict(params=_stack(0, 16), x=_x(1, (24, 16))),
    "grads": dict(params=_stack(2, 8), x=_x(3, (16, 8)), n_micro=4),
    "micro32": dict(params=_stack(4, 4), x=_x(5, (32, 4)), n_micro=32),
    "micro2": dict(params=_stack(6, 4), x=_x(7, (6, 4)), n_micro=2),
    "prime": dict(params=_stack(8, 4), x=_x(9, (7, 4))),
    "ragged": dict(params=_stack(10, 4), x=np.zeros((9, 4), np.float32), n_micro=4),
    "leading": dict(params={k: v[:2] for k, v in _stack(10, 4).items()},
                    x=np.zeros((8, 4), np.float32)),
}


def _layer_state_dict(p):
    """One Flax ``TorchTransformerLayer`` tree -> the port layer's names."""
    out = {"self_attn.in_proj_weight": p["in_proj"]["kernel"].T,
           "self_attn.in_proj_bias": p["in_proj"]["bias"],
           "self_attn.out_proj.weight": p["out_proj"]["kernel"].T,
           "self_attn.out_proj.bias": p["out_proj"]["bias"]}
    for name in ("linear1", "linear2"):
        out.update({f"{name}.weight": p[name]["kernel"].T, f"{name}.bias": p[name]["bias"]})
    for name in ("norm1", "norm2"):
        out.update({f"{name}.weight": p[name]["scale"], f"{name}.bias": p[name]["bias"]})
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    d, heads, seq = 16, 4, 6
    layer = JaxLayer(d, heads)
    xf = _x(20, (16, seq, d))
    stacked = jax.vmap(lambda k: layer.init(k, xf[:1], jnp.ones((1, seq)))["params"])(
        jax.random.split(jax.random.PRNGKey(21), N))
    layers = [_layer_state_dict(jax.tree.map(lambda a, i=i: np.asarray(a[i]), stacked))
              for i in range(N)]
    cases = {f"pipe:{k}": dict(c, params={n: torch.from_numpy(v) for n, v in c["params"].items()},
                               x=torch.from_numpy(c["x"])) for k, c in MLP.items()}
    cases["pipe_framediff"] = dict(layers=layers, d=d, heads=heads, x=torch.from_numpy(xf),
                                   n_micro=8)
    world = World(N, cases)

    def stage(p, xx):
        return layer.apply({"params": p}, xx, jnp.ones(xx.shape[:1] + (seq,)))

    ref = {"framediff": np.asarray(jax_pipeline(stage, stacked, jnp.asarray(xf), _mesh(),
                                                n_micro=8))}
    c = MLP["values"]
    ref["values"] = np.asarray(jax_pipeline(_stage, c["params"], jnp.asarray(c["x"]), _mesh()))
    c = MLP["grads"]

    def loss(p, xx):
        return jnp.sum(jax_pipeline(_stage, p, xx, _mesh(), n_micro=4) ** 2)

    ref["grads"] = jax.grad(loss, argnums=(0, 1))(c["params"], jnp.asarray(c["x"]))
    ref["seq_grads"] = jax.grad(lambda p, xx: jnp.sum(_seq(p, xx) ** 2), argnums=(0, 1))(
        c["params"], jnp.asarray(c["x"]))
    return world.join(), ref, layers, xf


@pytest.mark.parametrize("case", ["values", "micro32", "micro2"])
def test_pipeline_matches_jax_and_sequential(runs, case):
    """Against the sequential stack; ``values`` against JAX's pipeline too
    (JAX's own test holds its pipeline to the stack in the other two)."""
    outs, ref, _, _ = runs
    c = MLP[case]
    seq = np.asarray(_seq(c["params"], jnp.asarray(c["x"])))
    for out in outs:
        got = out[f"pipe:{case}"]["out"].numpy()
        np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)
        if case in ref:
            np.testing.assert_allclose(got, ref[case], rtol=1e-5, atol=1e-5)
        assert not out[f"pipe:{case}"]["warnings"]


def test_pipeline_gradients_match_jax_and_sequential(runs):
    outs, ref, _, _ = runs
    (jp, jx), (sp, sx) = ref["grads"], ref["seq_grads"]
    for out in outs:
        got = out["pipe:grads"]
        for k in ("w", "b"):
            np.testing.assert_allclose(got["grads"][k].numpy(), np.asarray(jp[k]), atol=1e-4)
            np.testing.assert_allclose(got["grads"][k].numpy(), np.asarray(sp[k]), atol=1e-4)
        np.testing.assert_allclose(got["x_grad"].numpy(), np.asarray(jx), atol=1e-4)
        np.testing.assert_allclose(got["x_grad"].numpy(), np.asarray(sx), atol=1e-4)


def test_pipeline_warns_on_degenerate_default_micro(runs):
    outs, _, _, _ = runs
    c = MLP["prime"]
    seq = np.asarray(_seq(c["params"], jnp.asarray(c["x"])))
    for out in outs:
        got = out["pipe:prime"]
        assert any("bubble" in w for w in got["warnings"])
        np.testing.assert_allclose(got["out"].numpy(), seq, rtol=1e-5, atol=1e-5)


def test_pipeline_rejects_bad_shapes(runs):
    outs, _, _, _ = runs
    for out in outs:
        assert "not divisible" in out["pipe:ragged"]["raised"]
        assert "leading axes" in out["pipe:leading"]["raised"]


def test_pipeline_framediff_seq_trunk(runs):
    outs, ref, layers, xf = runs
    seq_layers = []
    for sd_ in layers:
        layer = TorchTransformerLayer(16, 4)
        layer.load_state_dict(sd_)
        seq_layers.append(layer)
    x = torch.from_numpy(xf).requires_grad_(True)
    y = x
    for layer in seq_layers:
        y = layer(y, torch.ones(16, 6))
    (y ** 2).sum().backward()
    for r, out in enumerate(outs):
        got = out["pipe_framediff"]
        np.testing.assert_allclose(got["out"].numpy(), ref["framediff"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["out"].numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["x_grad"].numpy(), x.grad.numpy(), atol=1e-4)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), dict(seq_layers[r].named_parameters())[
                name].grad.numpy(), atol=1e-4, err_msg=name)
