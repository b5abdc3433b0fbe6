"""The port's struct2seq conditioner (CA ProteinMPNN, ESM2, MPNN_ESM) and the
struct2seq-conditioned Proteus vs the JAX package, fp32 on the CPU.

Tiny configs (``MPNNESMConfig.tiny``, ``ProteusConfig.tiny``), Flax trees of
numpy draws (every layer non-zero) carried into the port by
``mpnn_esm_from_flax`` / ``protein_net_from_flax``, and JAX's own draws
handed to the port: the decode-order normals and, per decode step, the
Gumbel noise whose argmax with the logits is ``jax.random.categorical``'s
draw. Held within 1e-5 of each output's largest magnitude: the MPNN's
teacher-forced log-probs, its sampled sequences (exactly), ESM2's
representations and attention maps, MPNN_ESM's ``esm_s`` / ``esm_p``, and
the conditioned Proteus embedder's node and edge streams; the whole
conditioned Proteus forward within the 1e-4 of ``test_torch_proteus.py``
(its template self-condition's degenerate frames, that file says why).
The converters cover the transformers ``EsmModel`` schema and the CA
ProteinMPNN names of the JAX mapping; a ProteinMPNN pickle, an ESM2 snapshot
and a struct2seq Proteus checkpoint load by ``load_state_dict`` and drive
the ``protein`` command.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params, t

from superdiff_tpu.models.protein import proteus as jproteus
from superdiff_tpu.models.protein import struct2seq as js2s
from superdiff_tpu_torch.models.from_jax import mpnn_esm_from_flax, protein_net_from_flax
from superdiff_tpu_torch.models.protein import convert
from superdiff_tpu_torch.models.protein import struct2seq as s2s
from superdiff_tpu_torch.models.protein.proteus import ProteusConfig, ProteusScoreNetwork

torch.set_num_threads(2)
B, N = 2, 12
TOL = 1e-5


def close(got, ref, tol=TOL, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-6), (what, err, np.abs(ref).max())


def chain_ca(b, n, seed):
    """A CA trace of ~3.8 A steps, some outside the (3.6, 4.0) window of the
    virtual-bond mask."""
    rng = np.random.default_rng(seed)
    steps = rng.standard_normal((b, n, 3))
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    return np.cumsum(steps * rng.uniform(3.4, 4.1, (b, n, 1)), axis=1).astype(np.float32)


def jax_draws(key, b, n, letters=21):
    """JAX's draws of one ``ProteinMPNNCA.sample(key, ...)``."""
    key_order, key_steps = jax.random.split(key)
    gumbel = [jax.random.gumbel(jax.random.fold_in(key_steps, i), (b, letters), jnp.float32)
              for i in range(n)]
    return {"randn": t(jax.random.normal(key_order, (b, n))), "gumbel": t(np.stack(gumbel))}


def self_condition(seed, b=B, n=N):
    pos = np.zeros((b, n, 37, 3), np.float32)
    pos[:, :, 1] = chain_ca(b, n, seed)
    return {"final_atom_positions": pos,
            "aatype": np.random.default_rng(seed).integers(0, 20, (b, n)).astype(np.int32)}


@pytest.fixture(scope="module")
def mpnn_esm():
    cfg = js2s.MPNNESMConfig.tiny()
    jmodel = js2s.MPNNESM(cfg)
    sc = {k: jnp.asarray(v) for k, v in self_condition(0).items()}
    params = draw_params(jmodel, sc, seed=11)
    pcfg = s2s.MPNNESMConfig(c_s=cfg.c_s, c_z=cfg.c_z, temperature=cfg.temperature,
                             seq_nums=cfg.seq_nums,
                             mpnn=s2s.MPNNConfig(**dataclasses.asdict(cfg.mpnn)),
                             esm=s2s.ESM2Config(**{k: v for k, v in
                                                   dataclasses.asdict(cfg.esm).items()
                                                   if k != "dtype"}))
    model = mpnn_esm_from_flax(s2s.MPNNESM(pcfg), params).eval()
    return cfg, jmodel, params, model


def test_configs_match_jax():
    for port, ref in ((s2s.MPNNConfig(), js2s.MPNNConfig()),
                      (s2s.MPNNConfig.tiny(), js2s.MPNNConfig.tiny())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for port, ref in ((s2s.ESM2Config(), js2s.ESM2Config()),
                      (s2s.ESM2Config.tiny(), js2s.ESM2Config.tiny())):
        want = {k: v for k, v in dataclasses.asdict(ref).items() if k != "dtype"}
        assert dataclasses.asdict(port) == want
    assert (s2s.AF_TO_MPNN == js2s.AF_TO_MPNN).all()
    assert (s2s.MPNN_TO_ESM == js2s.MPNN_TO_ESM).all()
    assert s2s.ESM_TOKENS == js2s.ESM_TOKENS


def test_mpnn_teacher_forced_matches_jax(mpnn_esm):
    cfg, _, params, model = mpnn_esm
    jm = js2s.ProteinMPNNCA(cfg.mpnn)
    rng = np.random.default_rng(3)
    ca = chain_ca(B, N, 4)
    s = rng.integers(0, 21, (B, N)).astype(np.int32)
    mask = np.ones((B, N), np.float32)
    ridx = np.broadcast_to(np.arange(N), (B, N)).astype(np.int32)
    chain = np.zeros((B, N), np.int32)
    order = np.argsort(rng.standard_normal((B, N)), -1).astype(np.int32)
    ref = jax.jit(jm.apply)({"params": params["mpnn_model"]}, ca, s, mask, mask, ridx, chain,
                            order)
    with torch.no_grad():
        got = model.mpnn_model(t(ca), t(s).long(), t(mask), t(mask), t(ridx).long(),
                               t(chain).long(), t(order).long())
    close(got, ref, what="log_probs")


def test_mpnn_sample_matches_jax_on_its_draws(mpnn_esm):
    cfg, _, params, model = mpnn_esm
    jm = js2s.ProteinMPNNCA(cfg.mpnn)
    ca = chain_ca(B, N, 5)
    mask = np.ones((B, N), np.float32)
    ridx = np.broadcast_to(np.arange(N), (B, N)).astype(np.int32)
    chain = np.zeros((B, N), np.int32)
    s_true = np.random.default_rng(6).integers(0, 21, (B, N)).astype(np.int32)
    chain_mask = (np.arange(N) % 3 != 0)[None].repeat(B, 0).astype(np.float32)
    key = jax.random.PRNGKey(7)
    args = tuple(map(jnp.asarray, (ca, mask, ridx, chain, s_true, chain_mask)))
    ref = jax.jit(lambda p, k, a: js2s.mpnn_sample(jm, p, k, *a))(params["mpnn_model"], key,
                                                                  args)
    got = model.mpnn_model.sample(t(ca), t(mask), t(ridx).long(), t(chain).long(),
                                  t(s_true).long(), t(chain_mask), draws=jax_draws(key, B, N))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # unsampled positions copy the given sequence
    assert (got.numpy()[:, ::3] == s_true[:, ::3]).all()


def test_esm2_matches_jax(mpnn_esm):
    cfg, _, params, model = mpnn_esm
    rng = np.random.default_rng(8)
    tokens = rng.integers(4, 24, (B, N + 2)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = js2s.ESM_CLS, js2s.ESM_EOS
    tokens[0, 3] = js2s.ESM_MASK  # the token-dropout rescale
    ref = jax.jit(js2s.ESM2(cfg.esm).apply)({"params": params["esm"]}, tokens)
    with torch.no_grad():
        got = model.esm(t(tokens).long())
    close(got["representations"], ref["representations"], what="representations")
    close(got["attentions"], ref["attentions"], what="attentions")


def mpnn_esm_draws(jmodel, params, seed, b=B, n=N):
    """The draws JAX's ``make_struct2seq_fn(model, params, seed)`` makes: its
    ``struct2seq`` stream's key as Flax's ``make_rng`` derives it, folded
    with each sequence's index."""
    key = jmodel.apply({"params": params}, method=lambda m: m.make_rng("struct2seq"),
                       rngs={"struct2seq": jax.random.PRNGKey(seed)})
    return [jax_draws(jax.random.fold_in(key, i), b, n) for i in range(jmodel.cfg.seq_nums)]


def test_mpnn_esm_matches_jax(mpnn_esm):
    cfg, jmodel, params, model = mpnn_esm
    sc = self_condition(9)
    ref = jax.jit(js2s.make_struct2seq_fn(jmodel, params, seed=2))(sc)
    with torch.no_grad():
        got = model({k: t(v) for k, v in sc.items()}, mpnn_esm_draws(jmodel, params, 2))
    close(got[0], ref[0], what="esm_s")
    close(got[1], ref[1], what="esm_p")
    assert got[0].shape == (B, cfg.seq_nums, N, cfg.c_s)
    assert got[1].shape == (B, cfg.seq_nums, N, N, cfg.c_z)


def test_mpnn_esm_draws_from_its_seed_without_draws(mpnn_esm):
    *_, model = mpnn_esm
    sc = {k: t(v) for k, v in self_condition(10).items()}
    with torch.no_grad():
        a, b = model(sc), model(sc)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all()


@pytest.fixture(scope="module")
def conditioned_proteus(mpnn_esm):
    cfg, jmodel, params, model = mpnn_esm
    jcfg = dataclasses.replace(jproteus.ProteusConfig.tiny(), struct2seq_enable=True)
    jnet = jproteus.ProteusScoreNetwork(jcfg, js2s.make_struct2seq_fn(jmodel, params, seed=4))
    from test_torch_proteus import feats_np, self_condition_np

    feats = feats_np(12)
    pparams = draw_params(jnet, feats, self_condition_np(13, jcfg), True, seed=14)
    emb = pparams["embedding_layer"]["template_embedder"]["template_angle_embedder"]
    emb["linear_1"]["kernel"][np.r_[22:26, 36:40]] = 0.0  # as test_torch_proteus.py
    pcfg = dataclasses.replace(ProteusConfig.tiny(), struct2seq_enable=True)
    pnet = protein_net_from_flax(ProteusScoreNetwork(pcfg, model), pparams).eval()
    return jnet, pparams, pnet, feats, self_condition_np(15, jcfg)


def test_conditioned_proteus_matches_jax(conditioned_proteus, mpnn_esm):
    jnet, pparams, pnet, feats, sc = conditioned_proteus
    tf = {k: t(v) for k, v in feats.items()}
    tsc = {k: t(v) for k, v in sc.items()}
    b, n = feats["res_mask"].shape
    draws = mpnn_esm_draws(mpnn_esm[1], mpnn_esm[2], 4, b, n)

    jemb = jproteus.ProteusEmbedder(jnet.cfg, jnet.struct2seq_fn)
    # the embedder's node and edge streams, with and without the branch
    for flag in (True, False):
        ref = jax.jit(lambda p, f, c: jemb.apply(
            {"params": p}, f, f["t"], f["fixed_mask"].astype(jnp.float32), c, flag))(
            pparams["embedding_layer"], feats, sc)
        with torch.no_grad():
            got = pnet.embedding_layer(tf, tf["t"], tf["fixed_mask"].float(), tsc, flag, draws)
        close(got[0], ref[0], what=f"node {flag}")
        close(got[1], ref[1], what=f"edge {flag}")
    ref = jax.jit(lambda p, f, c: jnet.apply({"params": p}, f, self_condition=c,
                                             struct2seq=True))(pparams, feats, sc)
    with torch.no_grad():
        got = pnet(tf, tsc, struct2seq=True, struct2seq_draws=draws)
        off = pnet(tf, tsc)
    for k in ("pred_trans", "pred_rotmats", "node_embed", "edge_embed"):
        close(got[k], ref[k], tol=1e-4, what=k)
    assert not torch.allclose(got["node_embed"], off["node_embed"])
    # the 0/1 tensor flag (JAX's traced gate): the branch runs, scaled by it
    for flag, want in ((1.0, got), (0.0, off)):
        ref = jax.jit(lambda p, f, c: jnet.apply({"params": p}, f, self_condition=c,
                                                 struct2seq=jnp.float32(flag)))(pparams, feats, sc)
        with torch.no_grad():
            out = pnet(tf, tsc, struct2seq=torch.tensor(flag), struct2seq_draws=draws)
        torch.testing.assert_close(out["node_embed"], want["node_embed"], rtol=0, atol=0)
        close(out["edge_embed"], ref["edge_embed"], tol=1e-4, what=f"flag {flag}")


def test_converters_cover_the_schemas(mpnn_esm):
    """ESM2 against a transformers ``EsmModel`` of the tiny config: every
    key of the port is one of the model's, the rest are the unused keys;
    the MPNN's keys are the JAX mapping's (held to the reference class by
    ``tests/test_struct2seq_parity.py``) and its unused keys; the port's
    mappings are JAX's."""
    from transformers.models.esm import EsmConfig, EsmModel

    from superdiff_tpu.models.protein import convert as jconvert

    cfg = s2s.ESM2Config.tiny()
    hf = EsmModel(EsmConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.embed_dim, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.attention_heads, intermediate_size=cfg.intermediate_dim,
        position_embedding_type="rotary", emb_layer_norm_before=False, token_dropout=True,
        pad_token_id=s2s.ESM_PAD, mask_token_id=s2s.ESM_MASK,
        layer_norm_eps=cfg.layer_norm_eps), add_pooling_layer=False)
    hsd = hf.state_dict()
    esm = s2s.ESM2(cfg)
    assert set(esm.state_dict()) <= set(hsd)
    assert set(hsd) - set(esm.state_dict()) <= set(convert.esm2_unused_keys(cfg))
    convert.load_esm2_state_dict(esm, hsd)
    torch.testing.assert_close(esm.encoder.layer[1].output.dense.weight,
                               hsd["encoder.layer.1.output.dense.weight"], rtol=0, atol=0)
    mcfg = s2s.MPNNConfig()
    mpnn = s2s.ProteinMPNNCA(mcfg)
    mapped = {k for k, _, _ in convert.mpnn_mapping(mcfg)}
    assert mapped | set(convert.mpnn_unused_keys(mcfg)) == set(mpnn.state_dict())
    for port, ref in ((convert.mpnn_mapping(mcfg), jconvert.mpnn_mapping(js2s.MPNNConfig())),
                      (convert.esm2_mapping(cfg), jconvert.esm2_mapping(js2s.ESM2Config.tiny())),
                      (convert.mpnn_esm_heads_mapping(), jconvert.mpnn_esm_heads_mapping())):
        assert [(k, p, tf is not None) for k, p, tf in port] == \
            [(k, p, tf is not None) for k, p, tf in ref]


def test_state_dict_keeps_only_the_heads(mpnn_esm):
    *_, model = mpnn_esm
    sd = model.state_dict()
    assert set(sd) == {k for k, _, _ in convert.mpnn_esm_heads_mapping()}
    pnet = ProteusScoreNetwork(dataclasses.replace(ProteusConfig.tiny(), struct2seq_enable=True),
                               s2s.MPNNESM(model.cfg))
    psd = pnet.state_dict()
    heads = convert.extract_struct2seq_heads(psd)
    assert set(heads) == set(sd)
    assert any(k.startswith("embedding_layer.struct2seq_cross_embedder.") for k in psd)
    pnet.load_state_dict(psd, strict=True)  # the frozen parts may be missing


def test_checkpoints_load_and_drive_the_cli(tmp_path, capsys):
    """A ProteinMPNN pickle (``{'num_edges', 'model_state_dict'}``), a local
    transformers ESM2 snapshot and a struct2seq Proteus checkpoint: the
    ``protein`` command composes with the branch on every step."""
    from transformers.models.esm import EsmConfig, EsmModel

    from superdiff_tpu_torch import cli

    mpnn = s2s.ProteinMPNNCA(dataclasses.replace(s2s.MPNNConfig(), k_neighbors=6))
    torch.save({"num_edges": 6, "model_state_dict": mpnn.state_dict()}, tmp_path / "mpnn.pt")
    sd, k = convert.load_mpnn_checkpoint(str(tmp_path / "mpnn.pt"))
    assert k == 6 and set(sd) == set(mpnn.state_dict())
    ecfg = s2s.ESM2Config.tiny()
    EsmModel(EsmConfig(
        vocab_size=ecfg.vocab_size, hidden_size=ecfg.embed_dim,
        num_hidden_layers=ecfg.num_layers, num_attention_heads=ecfg.attention_heads,
        intermediate_size=ecfg.intermediate_dim, position_embedding_type="rotary",
        emb_layer_norm_before=False, token_dropout=True, pad_token_id=s2s.ESM_PAD,
        mask_token_id=s2s.ESM_MASK, layer_norm_eps=ecfg.layer_norm_eps),
        add_pooling_layer=False).save_pretrained(tmp_path / "esm2")
    pcfg = dataclasses.replace(ProteusConfig(), struct2seq_enable=True)
    heads_model = s2s.MPNNESM(s2s.MPNNESMConfig(c_s=pcfg.node_embed_size,
                                                c_z=pcfg.edge_embed_size, esm=ecfg))
    psd = ProteusScoreNetwork(pcfg, heads_model).state_dict()
    from test_torch_proteus import _write_reference_pickle

    _write_reference_pickle(tmp_path / "proteus.pkl", psd,
                            {"embed": {"self_condition": {"struct2seq": {"enable": True}}}})
    out = tmp_path / "run"
    cli.main(["protein", "--device", "cpu", "--length", "8", "--num_t", "3",
              "--esm_rate", "1.0", "--ckpt_a", str(tmp_path / "proteus.pkl"),
              "--mpnn_ckpt", str(tmp_path / "mpnn.pt"), "--esm_dir", str(tmp_path / "esm2"),
              "--seq_nums", "2", "--out_dir", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["ll_a_trans"])
    assert (out / "len_8_seed_0.pdb").read_text().count(" CA ") == 8
