"""Ring attention (``superdiff_tpu_torch/parallel/sp.py``) on a gloo world
of 4 CPU processes, against the JAX package's ``ring_attention`` (on 4 of
the conftest's virtual devices) and plain attention.

Tolerances, as JAX's ``tests/test_sp.py``: fp32 within 1e-5 absolute of
plain fp32 attention and of JAX's ring (the online softmax merges the
blocks in ring order, sums in other orders); bf16 within 3e-2 of plain
fp32 attention (bf16 inputs, bf16 block matmuls, fp32 state), and within
1.6e-2 of JAX's bf16 ring (two bf16 roundings of outputs up to ~2, 7.8e-3
each). The ring posts N - 1 one-hop rotations (N - 1 calls of
``batch_isend_irecv``) and one all-gather of the shards per axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_dist import World

from superdiff_tpu.parallel.sp import ring_attention as jax_ring

torch.set_num_threads(1)

W = 4


def _qkv(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))


def _plain(q, k, v, scale):
    logits = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * scale
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))


def _jax_mesh(shape, names):
    return Mesh(np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


CASES = {
    "fp32": dict(qkv=_qkv(0, 2, 64, 4, 16), axes=(("sp", W),)),
    "bf16": dict(qkv=_qkv(1, 1, 128, 2, 8), axes=(("sp", W),), bf16=True),
    "data": dict(qkv=_qkv(2, 4, 32, 2, 16), axes=(("data", 2), ("sp", W // 2)),
                 batch_axis="data"),
    "scale": dict(qkv=_qkv(3, 2, 40, 2, 12), axes=(("sp", W),), scale=0.11),
    "ragged": dict(qkv=_qkv(4, 1, 38, 2, 8), axes=(("sp", W),)),
}


def _torch_inputs(case):
    dt = torch.bfloat16 if case.get("bf16") else torch.float32
    return dict(case, qkv=tuple(torch.from_numpy(a).to(dt) for a in case["qkv"]))


@pytest.fixture(scope="module")
def ring():
    world = World(W, {f"ring:{k}": _torch_inputs(c) for k, c in CASES.items()})
    ref = {}
    for k, c in CASES.items():
        if k == "ragged":
            continue
        shape = tuple(s for _, s in c["axes"])
        names = tuple(n for n, _ in c["axes"])
        qkv = [jnp.asarray(a, jnp.bfloat16 if c.get("bf16") else jnp.float32) for a in c["qkv"]]
        ref[k] = np.asarray(jax_ring(*qkv, _jax_mesh(shape, names), sm_scale=c.get("scale"),
                                     batch_axis=c.get("batch_axis")), np.float32)
    return world.join(), ref


@pytest.mark.parametrize("case", ["fp32", "data", "scale"])
def test_ring_fp32_matches_jax_and_plain(ring, case):
    outs, ref = ring
    q, k, v = CASES[case]["qkv"]
    scale = CASES[case].get("scale") or q.shape[-1] ** -0.5
    plain = _plain(q, k, v, scale)
    np.testing.assert_allclose(ref[case], plain, atol=1e-5)
    n_axes = len(CASES[case]["axes"])
    for out in outs:
        got = out[f"ring:{case}"]
        assert got["out"].dtype == torch.float32 and got["out"].shape == q.shape
        np.testing.assert_allclose(got["out"].numpy(), plain, atol=1e-5)
        np.testing.assert_allclose(got["out"].numpy(), ref[case], atol=1e-5)
        sp = dict(CASES[case]["axes"])["sp"]
        assert got["counts"]["batch_isend_irecv"] == sp - 1
        assert got["counts"]["all_gather_into_tensor"] == n_axes


def test_ring_bf16(ring):
    outs, ref = ring
    q, k, v = CASES["bf16"]["qkv"]
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v)]
    plain = _plain(*bf, 8 ** -0.5)
    for out in outs:
        got = out["ring:bf16"]["out"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), plain, atol=3e-2)
        np.testing.assert_allclose(got.float().numpy(), ref["bf16"], atol=1.6e-2)


def test_ring_rejects_ragged_sequence(ring):
    outs, _ = ring
    for out in outs:
        assert "not divisible" in out["ring:ragged"]["raised"]
    with pytest.raises(ValueError, match="not divisible"):
        q = jnp.zeros((1, 36, 2, 8))
        jax_ring(q, q, q, _jax_mesh((8,), ("sp",)))
