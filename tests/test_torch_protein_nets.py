"""Port protein score networks vs the JAX package, fp32 on the CPU:
``IPAScoreNetwork`` at a tiny config with full and k-NN-local attention,
and a tiny checkpoint-faithful ``FrameDiffScoreNetwork``, each carried from
a Flax tree of numpy draws (``draw_params``: every layer non-zero, the
zero-init heads included) by ``protein_net_from_flax``. One set of inputs
(random frames, a masked residue, fixed residues, a self-conditioning CA
carry) goes through both; every output is held within 1e-4 of its
largest value (fp32 through a few blocks of attention and frame updates)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_parity import draw_params, same_config, t

from superdiff_tpu.models.protein.framediff import FrameDiffConfig as JFDConfig
from superdiff_tpu.models.protein.framediff import FrameDiffScoreNetwork as JFrameDiff
from superdiff_tpu.models.protein.ipa import IPAConfig as JIPAConfig
from superdiff_tpu.models.protein.ipa import IPAScoreNetwork as JIPA
from superdiff_tpu.models.protein.r3 import R3Diffuser as JR3
from superdiff_tpu.models.protein.se3 import SE3Diffuser as JSE3
from superdiff_tpu.models.protein.so3 import SO3Diffuser as JSO3
from superdiff_tpu_torch.models.from_jax import protein_net_from_flax
from superdiff_tpu_torch.models.protein.framediff import FrameDiffConfig, FrameDiffScoreNetwork
from superdiff_tpu_torch.models.protein.ipa import IPAConfig, IPAScoreNetwork
from superdiff_tpu_torch.models.protein.r3 import R3Diffuser
from superdiff_tpu_torch.models.protein.se3 import SE3Diffuser
from superdiff_tpu_torch.models.protein.so3 import SO3Diffuser

torch.set_num_threads(1)
TABLES = dict(num_sigma=100, num_omega=200, L=200)
B, N = 2, 10
TOL = 1e-4


def feats_np(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[..., :1])
    trans = (6 * rng.standard_normal((B, N, 3))).astype(np.float32)
    res_mask = np.ones((B, N), np.float32)
    res_mask[1, -1] = 0.0
    fixed = np.zeros((B, N), np.float32)
    fixed[0, :2] = 1.0
    return {
        "rigids_t": np.concatenate([q, trans], -1),
        "res_mask": res_mask,
        "fixed_mask": fixed,
        "t": np.float32([0.83, 0.27]),
        "seq_idx": np.broadcast_to(np.arange(N), (B, N)).astype(np.int32),
        "sc_ca_t": (trans + rng.standard_normal((B, N, 3))).astype(np.float32),
    }


@pytest.fixture(scope="module")
def diffusers():
    return JSE3(r3=JR3(), so3=JSO3(**TABLES)), SE3Diffuser(R3Diffuser(), SO3Diffuser(**TABLES,
                                                                                    device="cpu"))


def run_both(jnet, tnet, feats):
    params = draw_params(jnet, feats, seed=1)
    ref = jax.jit(lambda p, f: jnet.apply({"params": p}, f))(params, feats)
    protein_net_from_flax(tnet, params).eval()
    with torch.no_grad():
        got = tnet({k: t(v) for k, v in feats.items()})
    return got, ref


def check(got, ref, keys):
    for k in keys:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err = np.abs(g - r).max()
        assert err <= TOL * np.abs(r).max(), f"{k}: max abs err {err} of {np.abs(r).max()}"


# JAX's ``IPAConfig.self_conditioning``, which no code reads (the nets
# always take the self-condition input)
IPA_UNREAD = ("self_conditioning",)
IPA_KEYS = ("rigids", "rot_score", "trans_score", "psi", "pred_trans", "pred_rotmats")


@pytest.mark.parametrize("local_k", [None, 4])
def test_ipa_score_network_matches_jax(diffusers, local_k):
    jse3, pse3 = diffusers
    feats = feats_np()
    jcfg = dataclasses.replace(JIPAConfig.tiny(), local_attention_k=local_k)
    pcfg = dataclasses.replace(IPAConfig.tiny(), local_attention_k=local_k)
    same_config(pcfg, jcfg, IPA_UNREAD)
    got, ref = run_both(JIPA(jcfg, jse3), IPAScoreNetwork(pcfg, pse3), feats)
    check(got, ref, [k for k in IPA_KEYS if k != "rot_score"])
    # a fixed residue keeps its frame, so its relative rotation is the
    # identity up to fp32 rounding (|rotvec| ~ 1e-7) and its rot score is
    # that rounding over the smoothing eps = 1e-6: noise in both frameworks,
    # held to its size; every other residue within TOL of the largest
    fixed = feats["fixed_mask"] > 0
    g, r = got["rot_score"].numpy(), np.asarray(ref["rot_score"])
    assert np.abs(g[fixed]).max() < 1e-3 and np.abs(r[fixed]).max() < 1e-3
    assert np.abs(g - r)[~fixed].max() <= TOL * np.abs(r).max()
    # the drawn update heads move the frames away from the input
    assert np.abs(np.asarray(ref["rigids"]) - feats["rigids_t"]).max() > 1e-2


def test_ipa_local_attention_changes_the_function(diffusers):
    """k-NN locality is live at k < n: the local net's scores differ from
    the full-attention net's on the same weights."""
    _, pse3 = diffusers
    feats = {k: t(v) for k, v in feats_np(2).items()}
    torch.manual_seed(0)
    full = IPAScoreNetwork(IPAConfig.tiny(), pse3).eval()
    for p in full.parameters():
        torch.nn.init.normal_(p, std=0.3)
    local = IPAScoreNetwork(dataclasses.replace(IPAConfig.tiny(), local_attention_k=3), pse3)
    local.load_state_dict(full.state_dict())
    with torch.no_grad():
        a, b = full(feats)["trans_score"], local.eval()(feats)["trans_score"]
    assert (a - b).abs().max() > 1e-4


def test_framediff_score_network_matches_jax(diffusers):
    jse3, pse3 = diffusers
    feats = feats_np(3)
    got, ref = run_both(JFrameDiff(JFDConfig.tiny(), score_calc=jse3),
                        FrameDiffScoreNetwork(FrameDiffConfig.tiny(), score_calc=pse3), feats)
    check(got, ref, IPA_KEYS)


def test_framediff_fixed_residues_keep_ground_truth_psi(diffusers):
    jse3, pse3 = diffusers
    feats = feats_np(4)
    feats["torsion_angles_sin_cos"] = np.random.default_rng(5).standard_normal(
        (B, N, 7, 2)).astype(np.float32)
    got, ref = run_both(JFrameDiff(JFDConfig.tiny()),
                        FrameDiffScoreNetwork(FrameDiffConfig.tiny()), feats)
    check(got, ref, ("rigids", "psi"))
    np.testing.assert_array_equal(got["psi"][0, :2].numpy(),
                                  feats["torsion_angles_sin_cos"][0, :2, 2])
    assert "rot_score" not in got


def test_framediff_config_from_ckpt_conf_matches_jax():
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures", "framediff_state_dict_schema.json")
    conf = json.load(open(path))["model_conf"]
    assert (dataclasses.asdict(FrameDiffConfig.from_ckpt_conf(conf))
            == dataclasses.asdict(JFDConfig.from_ckpt_conf(conf)))
    assert dataclasses.asdict(FrameDiffConfig()) == dataclasses.asdict(JFDConfig())
    for name in ("framediff_like", "proteus_like", "tiny"):
        same_config(getattr(IPAConfig, name)(), getattr(JIPAConfig, name)(), IPA_UNREAD)
