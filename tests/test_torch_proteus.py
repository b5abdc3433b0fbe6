"""Port Proteus network and the reference checkpoint path vs the JAX
package, fp32 on the CPU.

* A tiny ``ProteusScoreNetwork`` carried from a Flax tree of numpy draws
  (every layer non-zero) by ``protein_net_from_flax``, run without a
  self-condition, with the template self-condition (atoms and the node /
  edge embeddings of a previous step), with real template features, and at
  identity rigids, where every CA sits at the origin and the k-NN picks of
  the local triangle attention are all ties (broken by the lower index, as
  ``lax.top_k`` does). Every output within 1e-4 of its largest value.
  The self-condition's torsion features hold residue 0's pre-omega and phi,
  whose frames are built with the absent previous residue's atoms (zeros):
  degenerate, so their sin / cos follow rounding (XLA's jit, which
  contracts multiply-adds, and op-by-op JAX land apart, and the drawn
  weights carry that ~10 % into the frames). The drawn angle embedder reads
  those four feature columns with zero weights here; the all-atom functions
  themselves are held directly, those two angles of residue 0 aside.
* FrameDiff and Proteus at the checkpoints' ``model_conf``, built on the
  ``meta`` device: their ``state_dict`` keys and shapes equal the
  reference schemas (282 and 517 tensors) in ``tests/fixtures``.
* ``load_torch_checkpoint`` on a pickle written here the way the
  reference writes one (``module.`` prefix, an omegaconf ``conf``),
  loaded by ``load_state_dict``.
"""

import dataclasses
import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params, same_config, t

from superdiff_tpu.models.protein.proteus import ProteusConfig as JProteusConfig
from superdiff_tpu.models.protein.proteus import ProteusScoreNetwork as JProteus
from superdiff_tpu_torch.models.from_jax import protein_net_from_flax
from superdiff_tpu_torch.models.protein import backbone, convert
from superdiff_tpu_torch.models.protein import residue_constants as rc
from superdiff_tpu_torch.models.protein.framediff import FrameDiffConfig, FrameDiffScoreNetwork
from superdiff_tpu_torch.models.protein.proteus import ProteusConfig, ProteusScoreNetwork

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
B, N = 2, 9
TOL = 1e-4
OUT_KEYS = ("rigids", "pred_trans", "pred_rotmats", "final_atom_positions",
            "final_atom_mask", "node_embed", "edge_embed")


def fixture(name):
    with open(os.path.join(FIXTURES, f"{name}_state_dict_schema.json")) as f:
        return json.load(f)


def feats_np(seed, identity=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[..., :1])
    trans = (5 * rng.standard_normal((B, N, 3))).astype(np.float32)
    if identity:
        q = np.zeros_like(q)
        q[..., 0] = 1.0
        trans = np.zeros_like(trans)
    eye = np.eye
    return {
        "aatype": rng.integers(0, 20, (B, N)).astype(np.int32),
        "residue_index": np.broadcast_to(np.arange(N), (B, N)).astype(np.int32),
        "chain_index": np.zeros((B, N), np.int32),
        "res_mask": np.ones((B, N), np.float32),
        "fixed_mask": (np.arange(N) < 2)[None].repeat(B, 0).astype(np.float32),
        "rigids_t": np.concatenate([q, trans], -1),
        "t": np.float32([0.7, 0.2]),
        "ss": eye(4, dtype=np.float32)[rng.integers(0, 4, (B, N))],
        "adjacency": eye(3, dtype=np.float32)[rng.integers(0, 3, (B, N, N))],
        "hotspot": eye(2, dtype=np.float32)[rng.integers(0, 2, (B, N))],
        "torsion_angles_sin_cos": rng.standard_normal((B, N, 7, 2)).astype(np.float32),
    }


def backbone_atoms(rng, lead):
    """atom37 positions of a random backbone (N, CA, C, CB, O placed from
    random frames as the composition's atoms are), the rest zero, and the
    standard atom masks of random residue types. A random mask over
    backbone atoms would make the torsion frames degenerate, whose sign
    then follows rounding (JAX jitted and eager disagree there)."""
    q = rng.standard_normal(lead + (4,)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r7 = np.concatenate([q, (4 * rng.standard_normal(lead + (3,))).astype(np.float32)], -1)
    pos = backbone.to_atom37(torch.from_numpy(r7)).numpy()
    aatype = rng.integers(0, 20, lead[:-1] + (N,)).astype(np.int32)
    return pos, rc.STANDARD_ATOM_MASK[aatype].astype(np.float32), aatype


def self_condition_np(seed, cfg):
    rng = np.random.default_rng(seed)
    pos, mask, _ = backbone_atoms(rng, (B, N))
    return {
        "final_atom_positions": pos,
        "final_atom_mask": mask,
        "node_embed": rng.standard_normal((B, N, cfg.node_embed_size)).astype(np.float32),
        "edge_embed": rng.standard_normal((B, N, N, cfg.edge_embed_size)).astype(np.float32),
    }


def templates_np(seed, s=2):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, s), np.float32)
    mask[:, 1] = 0.0  # a template empty across the batch: zeroed
    pos, atom_mask, aatype = backbone_atoms(rng, (B, s, N))
    return {
        "template_aatype": aatype,
        "template_mask": mask,
        "template_all_atom_positions": pos,
        "template_all_atom_mask": atom_mask,
        "template_pseudo_beta": (4 * rng.standard_normal((B, s, N, 3))).astype(np.float32),
        "template_pseudo_beta_mask": (rng.random((B, s, N)) > 0.1).astype(np.float32),
        "template_torsion_angles_sin_cos": rng.standard_normal((B, s, N, 7, 2)).astype(
            np.float32),
        "template_alt_torsion_angles_sin_cos": rng.standard_normal((B, s, N, 7, 2)).astype(
            np.float32),
        "template_torsion_angles_mask": (rng.random((B, s, N, 7)) > 0.3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def nets():
    jnet = JProteus(JProteusConfig.tiny())
    params = draw_params(jnet, feats_np(0), seed=3)
    # the angle features' pre-omega / phi sin-cos columns (and their alt
    # twins) get zero weights (see the module docstring)
    emb = params["embedding_layer"]["template_embedder"]["template_angle_embedder"]
    emb["linear_1"]["kernel"][np.r_[22:26, 36:40]] = 0.0
    pnet = protein_net_from_flax(ProteusScoreNetwork(ProteusConfig.tiny()), params).eval()
    apply = jax.jit(lambda f, sc: jnet.apply({"params": params}, f, self_condition=sc))
    return apply, pnet


CASES = {
    "no_self_condition": lambda cfg: (feats_np(1), None),
    "template_self_condition": lambda cfg: (feats_np(2), self_condition_np(3, cfg)),
    "templates_and_self_condition": lambda cfg: (
        {**feats_np(4), **templates_np(5)}, self_condition_np(6, cfg)),
    "identity_rigids_knn_ties": lambda cfg: (feats_np(7, identity=True), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_proteus_matches_jax(nets, case):
    apply, pnet = nets
    feats, sc = CASES[case](pnet.cfg)
    ref = apply(feats, sc)
    with torch.no_grad():
        got = pnet({k: t(v) for k, v in feats.items()},
                   None if sc is None else {k: t(v) for k, v in sc.items()})
    pairs = [(k, got[k], ref[k]) for k in OUT_KEYS]
    pairs += [(k, got["auxiliary"][k], ref["auxiliary"][k]) for k in ref["auxiliary"]]
    for k, g, r in pairs:
        r = np.asarray(r)
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err = np.abs(g.numpy() - r).max()
        assert err <= TOL * max(np.abs(r).max(), 1e-6), (k, err, np.abs(r).max())
    if case == "identity_rigids_knn_ties":
        # all CAs coincide: the local attention's neighbour sets are pure ties
        assert np.asarray(ref["rigids"])[..., 4:].std() > 0


def test_all_atom37_matches_jax():
    """Torsions, rigid-group frames, atom14 / atom37 and the template
    features on realistic backbones, at 1e-5 of the largest value; residue
    0's pre-omega and phi (degenerate frames, see the module docstring) are
    left out of the torsion comparison."""
    from superdiff_tpu.models.protein import all_atom37 as jaa
    from superdiff_tpu.models.protein import proteus as jproteus
    from superdiff_tpu_torch.models.protein import all_atom37 as aa
    from superdiff_tpu_torch.models.protein import proteus

    rng = np.random.default_rng(8)
    pos, mask, aatype = backbone_atoms(rng, (B, N))

    def close(g, r, tol=1e-5):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= tol * max(1.0, np.abs(r).max())

    jt = jax.jit(jaa.atom37_to_torsion_angles)(aatype, pos, mask)
    pt = aa.atom37_to_torsion_angles(t(aatype), t(pos), t(mask))
    keep = np.ones((B, N, 7, 1), bool)
    keep[:, 0, :2] = False
    for g, r in zip(pt[:2], jt[:2]):
        close(torch.where(torch.from_numpy(keep), g, 0.0), np.where(keep, r, 0.0))
    close(pt[2], jt[2])
    jb = jaa.pseudo_beta_fn(aatype, pos, mask)
    pb = aa.pseudo_beta_fn(t(aatype), t(pos), t(mask))
    close(pb[0], jb[0])
    close(pb[1], jb[1])
    r7 = pos[..., 1, :]  # CA as translation, random frames below
    q = rng.standard_normal((B, N, 4)).astype(np.float32)
    rot = np.asarray(jax.jit(lambda x: x / jnp.linalg.norm(x, axis=-1, keepdims=True))(q))
    from superdiff_tpu.models.protein import rigid as jrigid
    rotm = np.asarray(jrigid.quat_to_rotmat(jnp.asarray(rot)))
    alpha = rng.standard_normal((B, N, 7, 2)).astype(np.float32)
    jf = jax.jit(jaa.torsion_angles_to_frames)(rotm, r7, alpha, aatype)
    pf = aa.torsion_angles_to_frames(t(rotm), t(r7), t(alpha), t(aatype))
    close(pf[0], jf[0])
    close(pf[1], jf[1])
    j14 = jax.jit(jaa.frames_to_atom14_pos)(*jf, aatype)
    p14 = aa.frames_to_atom14_pos(*pf, t(aatype))
    close(p14, j14)
    close(aa.atom14_to_atom37(p14, t(aatype)), jax.jit(jaa.atom14_to_atom37)(j14, aatype))
    jm = jaa.make_atom14_masks(jnp.asarray(aatype))
    for k, v in aa.make_atom14_masks(t(aatype)).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jm[k]))
    jr = jax.jit(jaa.make_transform_from_reference)(pos[..., 0, :], pos[..., 1, :], pos[..., 2, :])
    pr = aa.make_transform_from_reference(t(pos[..., 0, :]), t(pos[..., 1, :]), t(pos[..., 2, :]))
    close(pr[0], jr[0])
    tb = templates_np(9)
    jp = jax.jit(lambda f: jproteus.build_template_pair_feat(f, 3.25, 50.75, 39, eps=1e-6,
                                                           inf=1e9))(tb)
    close(proteus.build_template_pair_feat({k: t(v) for k, v in tb.items()}, 3.25, 50.75, 39,
                                           eps=1e-6, inf=1e9), jp)
    close(proteus.build_template_angle_feat({k: t(v) for k, v in tb.items()}),
          jax.jit(jproteus.build_template_angle_feat)(tb))
    pos_f = proteus.positional_pair_features(
        t(np.arange(N)[None].repeat(B, 0)), t(np.r_[np.zeros(4), np.ones(N - 4)][None]
                                              .repeat(B, 0).astype(np.int32)), 4, "monomer")
    ref = jproteus.positional_pair_features(
        jnp.arange(N)[None].repeat(B, 0), jnp.asarray(np.r_[np.zeros(4), np.ones(N - 4)][None]
                                                      .repeat(B, 0).astype(np.int32)), 4,
        "monomer")
    np.testing.assert_array_equal(pos_f.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name,cls,cfg_cls", [
    ("framediff", FrameDiffScoreNetwork, FrameDiffConfig),
    ("proteus", ProteusScoreNetwork, ProteusConfig),
])
def test_state_dict_equals_reference_schema(name, cls, cfg_cls):
    fx = fixture(name)
    with torch.device("meta"):
        net = cls(cfg_cls.from_ckpt_conf(fx["model_conf"]))
    got = {k: list(v.shape) for k, v in net.state_dict().items()}
    assert len(got) == {"framediff": 282, "proteus": 517}[name]
    assert got == fx["schema"]


# JAX's ``lta_enable``, which no code reads: the local triangle attention is
# always built, and a checkpoint without it fails to load
PROTEUS_UNREAD = ("lta_enable",)


def test_proteus_config_matches_jax():
    conf = fixture("proteus")["model_conf"]
    for port, ref in ((ProteusConfig.from_ckpt_conf(conf), JProteusConfig.from_ckpt_conf(conf)),
                      (ProteusConfig.tiny(), JProteusConfig.tiny()),
                      (ProteusConfig(), JProteusConfig())):
        same_config(port, ref, PROTEUS_UNREAD)


def test_struct2seq_config_raises_naming_the_module():
    """A struct2seq config builds its cross embedder; a step that asks for
    the branch without an MPNN + ESM conditioner warns, naming struct2seq,
    and runs without it, as JAX's does (the branch itself:
    test_torch_struct2seq.py)."""
    cfg = dataclasses.replace(ProteusConfig.tiny(), struct2seq_enable=True)
    net = ProteusScoreNetwork(cfg).eval()
    assert hasattr(net.embedding_layer, "struct2seq_cross_embedder")
    feats = {k: t(v) for k, v in feats_np(1).items()}
    with torch.no_grad():
        off = net(feats)
        with pytest.warns(UserWarning, match="struct2seq"):
            on = net(feats, struct2seq=True)
    assert torch.equal(off["pred_trans"], on["pred_trans"])


def _write_reference_pickle(path, state_dict, model_conf):
    """A checkpoint as the reference trainer saves one: DDP keys and an
    omegaconf ``conf`` (the classes stood in for by a throwaway module, as
    omegaconf is not installed)."""
    pkg, mod = types.ModuleType("omegaconf"), types.ModuleType("omegaconf.dictconfig")
    pkg.dictconfig = mod

    class DictConfig:
        def __init__(self, content):
            self._content = content

    DictConfig.__module__ = "omegaconf.dictconfig"
    DictConfig.__qualname__ = "DictConfig"
    mod.DictConfig = DictConfig
    sys.modules.update({"omegaconf": pkg, "omegaconf.dictconfig": mod})
    try:
        conf = DictConfig({"model": DictConfig(model_conf)})
        torch.save({"model": {f"module.{k}": v for k, v in state_dict.items()},
                    "conf": conf, "epoch": 3}, path, pickle_protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        del sys.modules["omegaconf"], sys.modules["omegaconf.dictconfig"]


def test_load_torch_checkpoint_then_load_state_dict(tmp_path):
    cfg = FrameDiffConfig.tiny()
    conf = {"node_embed_size": cfg.node_embed_size, "edge_embed_size": cfg.edge_embed_size,
            "embed": {"index_embed_size": cfg.index_embed_size},
            "ipa": {"c_hidden": cfg.c_hidden, "c_skip": cfg.c_skip, "no_heads": cfg.no_heads,
                    "no_qk_points": cfg.no_qk_points, "no_v_points": cfg.no_v_points,
                    "seq_tfmr_num_heads": cfg.seq_tfmr_num_heads,
                    "seq_tfmr_num_layers": cfg.seq_tfmr_num_layers,
                    "num_blocks": cfg.num_blocks}}
    torch.manual_seed(0)
    src = FrameDiffScoreNetwork(cfg)
    for p in src.parameters():
        torch.nn.init.normal_(p)
    path = tmp_path / "framediff.pth"
    _write_reference_pickle(path, src.state_dict(), conf)
    sd, got_conf = convert.load_torch_checkpoint(str(path))
    assert got_conf["model"] == conf
    assert set(sd) == set(src.state_dict())  # "module." stripped
    dst = FrameDiffScoreNetwork(FrameDiffConfig.from_ckpt_conf(got_conf["model"]))
    dst.load_state_dict(sd, strict=True)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)


def test_cli_builds_models_from_reference_checkpoints(tmp_path):
    """``cli.build_protein_model``: a FrameDiff pickle with its conf and a
    Proteus pickle without one (the default config; recognised by its
    template-embedder keys) load strictly and score; a directory (the JAX
    package's Orbax format) and a missing file raise."""
    from superdiff_tpu_torch import cli
    from superdiff_tpu_torch.models.protein import R3Diffuser, SE3Diffuser, SO3Diffuser, rigid

    se3 = SE3Diffuser(R3Diffuser(), SO3Diffuser(num_sigma=100, num_omega=200, L=200,
                                                device="cpu"))
    n = 5
    feats = {"rigids_t": rigid.rigid_identity((1, n), device="cpu"),
             "res_mask": torch.ones(1, n), "fixed_mask": torch.zeros(1, n),
             "t": torch.full((1,), 0.5), "seq_idx": torch.arange(n)[None],
             "sc_ca_t": torch.randn(1, n, 3)}
    cfg = FrameDiffConfig.tiny()
    conf = {"node_embed_size": cfg.node_embed_size, "edge_embed_size": cfg.edge_embed_size,
            "embed": {"index_embed_size": cfg.index_embed_size},
            "ipa": {"c_hidden": cfg.c_hidden, "c_skip": cfg.c_skip, "no_heads": cfg.no_heads,
                    "no_qk_points": cfg.no_qk_points, "no_v_points": cfg.no_v_points,
                    "seq_tfmr_num_heads": cfg.seq_tfmr_num_heads,
                    "seq_tfmr_num_layers": cfg.seq_tfmr_num_layers,
                    "num_blocks": cfg.num_blocks}}
    _write_reference_pickle(tmp_path / "fd.pt", FrameDiffScoreNetwork(cfg).state_dict(), conf)
    model, adapter = cli.build_protein_model(str(tmp_path / "fd.pt"), None, se3, 0, "cpu")
    assert adapter is None
    with torch.no_grad():
        out = model(feats, feats["t"])
    assert out["rot_score"].shape == out["trans_score"].shape == (1, n, 3)

    torch.save({"model": ProteusScoreNetwork(ProteusConfig()).state_dict()}, tmp_path / "p.pkl")
    model, (sc_init, sc_update) = cli.build_protein_model(str(tmp_path / "p.pkl"), None, se3,
                                                          0, "cpu")
    feats["self_cond"] = sc_init(feats["rigids_t"])
    with torch.no_grad():
        out = model(feats, feats["t"])
    assert torch.isfinite(out["trans_score"]).all() and out["rot_score"].shape == (1, n, 3)
    assert sc_update(out)["final_atom_positions"].shape == (1, n, 37, 3)

    for bad, msg in ((tmp_path, "Orbax"), (tmp_path / "absent.pt", "not found")):
        with pytest.raises(SystemExit, match=msg):
            cli.build_protein_model(str(bad), None, se3, 0, "cpu")
