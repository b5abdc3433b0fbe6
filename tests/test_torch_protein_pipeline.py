"""The port's SE(3) composition vs the JAX package, fp32 on the CPU.

* ``compose`` under ``OR``, ``AND``, ``mixture``, ``baseline_a`` and
  ``baseline_b`` on two tiny IPA nets (model a k-NN-local) carried from
  Flax trees of numpy draws, with JAX's own draws injected: its initial
  rigids (``sample_ref`` of the split key) and the eps of every step
  (``normal(split(fold_in(key, i))[0])``), replayed here; nothing in the
  JAX package changes. Against JAX's jitted ``compose``: the final rigids
  and every trace within 1e-4 of its largest value (a few reverse steps
  through two nets in fp32; the log-likelihoods relative to their largest
  per-step increment, as the running sums cancel), and the quaternions
  within 1e-4.
* The port against ``tests/golden/protein.npz`` at that file's own
  ``RTOL = ATOL = 1e-4``, its nets initialised by JAX (``net.init``) and
  carried over.
* ``superdiff_tpu_torch.cli protein --device cpu`` end to end.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params

from superdiff_tpu.models.protein import R3Diffuser as JR3
from superdiff_tpu.models.protein import SE3Diffuser as JSE3
from superdiff_tpu.models.protein import SO3Diffuser as JSO3
from superdiff_tpu.models.protein import rigid as jrigid
from superdiff_tpu.models.protein.ipa import IPAConfig as JIPAConfig
from superdiff_tpu.models.protein.ipa import IPAScoreNetwork as JIPA
from superdiff_tpu.pipelines import protein as jprotein
from superdiff_tpu_torch.models.from_jax import protein_net_from_flax
from superdiff_tpu_torch.models.protein import IPAConfig, IPAScoreNetwork, R3Diffuser, \
    SE3Diffuser, SO3Diffuser, backbone
from superdiff_tpu_torch.pipelines import protein

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = dict(num_sigma=100, num_omega=200, L=200)
N, NUM_T = 12, 5
TOL = 1e-4
TRACES = ("kappa_trans", "kappa_rots", "ll_a_trans", "ll_b_trans", "ll_a_rots",
          "ll_b_rots", "rigids")


@pytest.fixture(scope="module")
def diffusers():
    return (JSE3(r3=JR3(), so3=JSO3(**TABLES)),
            SE3Diffuser(R3Diffuser(), SO3Diffuser(**TABLES, device="cpu")))


def feats0(batch):
    return {
        "rigids_t": jrigid.rigid_identity((batch, N)),
        "res_mask": jnp.ones((batch, N)),
        "fixed_mask": jnp.zeros((batch, N)),
        "t": jnp.ones((batch,)),
        "seq_idx": jnp.broadcast_to(jnp.arange(N)[None], (batch, N)),
        "sc_ca_t": jnp.zeros((batch, N, 3)),
    }


KEY, BATCH = 3, 1  # the golden's compose key and batch, shared by every case


@pytest.fixture(scope="module")
def draws(diffusers):
    """The draws JAX's ``compose`` takes from ``PRNGKey(KEY)``: (init_rigids,
    the unscaled eps of each step)."""
    key, init_key = jax.random.split(jax.random.PRNGKey(KEY))
    init = np.array(diffusers[0].sample_ref(init_key, N, BATCH))  # eagerly, as compose does
    eps = np.stack([np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(key, i))[0], (BATCH, N, 3)))
        for i in range(NUM_T - 1)])
    return torch.from_numpy(init), torch.from_numpy(eps)


def port_ipa_config(jcfg):
    """The port's ``IPAConfig`` of a JAX one (the fields the port carries)."""
    keep = {f.name for f in dataclasses.fields(IPAConfig)}
    return IPAConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in keep})


def nets(diffusers, params_a, params_b, cfg_a, cfg_b):
    jse3, pse3 = diffusers
    ja, jb = JIPA(cfg_a, jse3), JIPA(cfg_b, jse3)
    pa = protein_net_from_flax(IPAScoreNetwork(port_ipa_config(cfg_a), pse3), params_a).eval()
    pb = protein_net_from_flax(IPAScoreNetwork(port_ipa_config(cfg_b), pse3), params_b).eval()
    jmodels = (lambda f, t: ja.apply({"params": params_a}, f),
               lambda f, t: jb.apply({"params": params_b}, f))
    pmodels = (lambda f, t: pa(f), lambda f, t: pb(f))
    return jmodels, pmodels


METHODS = {
    "OR": dict(kappa_operator="OR", temp_trans=0.02, temp_rots=0.5, logp_trans=0.3),
    "AND": dict(kappa_operator="AND", logp_trans=0.7, logp_rots=-0.4),
    "mixture": dict(mixing_method="mixture", kappa_fixed=0.3),
    "baseline_a": dict(mixing_method="baseline_a"),
    "baseline_b": dict(mixing_method="baseline_b"),
}


@pytest.fixture(scope="module")
def drawn(diffusers):
    """Two one-block tiny IPA nets of drawn (non-zero) weights (one block
    keeps JAX's scan compile short; the nets' blocks are held in
    ``test_torch_protein_nets.py``): a k-NN-local model a and a
    full-attention model b, so the two scores differ and kappa moves."""
    cfg_b = dataclasses.replace(JIPAConfig.tiny(), num_blocks=1)
    cfg_a = dataclasses.replace(cfg_b, local_attention_k=6)
    f = feats0(BATCH)
    pa = draw_params(JIPA(cfg_a, diffusers[0]), f, seed=11)
    pb = draw_params(JIPA(cfg_b, diffusers[0]), f, seed=12)
    # small update heads keep the frames' steps moderate over the trajectory
    for p in (pa, pb):
        for i in range(cfg_a.num_blocks):
            p[f"bb_update_{i}"]["kernel"] *= 0.1
    return nets(diffusers, pa, pb, cfg_a, cfg_b)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_compose_matches_jax_on_jax_draws(diffusers, drawn, draws, method):
    jse3, pse3 = diffusers
    (ja, jb), (pa, pb) = drawn
    kw = dict(METHODS[method], num_t=NUM_T, noise_scale=0.5)
    ref = jprotein.compose(jax.random.PRNGKey(KEY), ja, jb, jse3, n_res=N,
                           cfg=jprotein.CompositionConfig(**kw), batch=BATCH)
    init, eps = draws
    got = protein.compose(pa, pb, pse3, n_res=N, cfg=protein.CompositionConfig(**kw),
                          batch=BATCH, init_rigids=init, noise=eps)
    np.testing.assert_array_equal(got["init_rigids"].numpy(), np.asarray(ref["init_rigids"]))
    for k in TRACES:
        g, r = got["traces"][k].numpy(), np.asarray(ref["traces"][k])
        assert g.shape == r.shape, (k, g.shape, r.shape)
        scale = np.abs(r).max()
        if k.startswith("ll_"):
            scale = np.abs(np.diff(r, axis=0, prepend=0.0)).max()
        assert np.abs(g - r).max() <= TOL * max(scale, 1e-6), (k, np.abs(g - r).max(), scale)
    close = np.abs(got["rigids"].numpy() - np.asarray(ref["rigids"])).max()
    assert close <= TOL * np.abs(np.asarray(ref["rigids"])).max()
    # the quaternions apart, on their own unit scale (the translations set
    # the rigids' largest value)
    for g, r in ((got["rigids"], ref["rigids"]),
                 (got["traces"]["rigids"], ref["traces"]["rigids"])):
        assert np.abs(g.numpy()[..., :4] - np.asarray(r)[..., :4]).max() <= TOL
    assert np.abs(got["atom37"].numpy() - np.asarray(ref["atom37"])).max() <= 1e-3
    kt = got["traces"]["kappa_trans"]
    if method in ("OR", "AND"):
        assert kt.max() - kt.min() > 1e-3  # kappa moves between the two models
        if method == "OR":
            assert ((kt >= 0) & (kt <= 1)).all()
    else:
        want = {"mixture": 0.3, "baseline_a": 1.0, "baseline_b": 0.0}[method]
        assert (kt == want).all()


def test_matches_golden_trajectory(diffusers, draws):
    """``tests/test_golden_trajectories.py::protein_trajectories`` in the
    port: JAX-initialised tiny IPA nets (keys 0 and 7), compose key 3,
    ``num_t=5``, OR and AND, on JAX's draws. kappa and the translations
    within the file's 1e-4. Its nets' update heads are zero-initialised,
    so each predicted frame is its input frame and each rotation score is
    the IGSO(3) score at an identity relative rotation (|rotvec| ~ 1e-7 of
    rounding over the smoothing eps 1e-6), so one ulp in the 3x3 product
    R_t^T R_0 moves the rotation score by a sixth of its size (XLA's CPU
    dot is an FMA chain, torch's product is not). The golden's rotations
    follow XLA's fused rounding: JAX itself run op by op
    (``jax.disable_jit``) lands 5.5158e-4 from them, the port 5.5152e-4,
    and the port 5.4812e-4 from JAX op by op (on an x86 CPU): quaternions
    within 1e-3. ``test_compose_matches_jax_on_jax_draws`` holds them at
    1e-4 where the nets' update heads are non-zero."""
    jse3, pse3 = diffusers
    golden = np.load(os.path.join(ROOT, "tests", "golden", "protein.npz"))
    init = jax.jit(JIPA(JIPAConfig.tiny(), jse3).init)
    f = feats0(1)
    pa, pb = (jax.device_get(init(jax.random.PRNGKey(k), f)["params"]) for k in (0, 7))
    _, (ma, mb) = nets(diffusers, pa, pb, JIPAConfig.tiny(), JIPAConfig.tiny())
    for op in ("OR", "AND"):
        out = protein.compose(ma, mb, pse3, n_res=N, init_rigids=draws[0], noise=draws[1],
                              cfg=protein.CompositionConfig(num_t=NUM_T, kappa_operator=op))
        for k in ("kappa_trans", "kappa_rots"):
            np.testing.assert_allclose(out["traces"][k].numpy(), golden[f"protein_{op}_{k}"],
                                       rtol=1e-4, atol=1e-4, err_msg=f"protein_{op}_{k}")
        ref = golden[f"protein_{op}_rigids"]
        np.testing.assert_allclose(out["rigids"][..., 4:].numpy(), ref[..., 4:], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(out["rigids"][..., :4].numpy(), ref[..., :4], rtol=0,
                                   atol=1e-3)


def test_compose_draws_from_its_generator_and_checks_shapes(diffusers, drawn):
    _, pse3 = diffusers
    _, (pa, pb) = drawn
    cfg = protein.CompositionConfig(num_t=3)
    a = protein.compose(pa, pb, pse3, n_res=N, cfg=cfg, batch=2, seed=4)
    b = protein.compose(pa, pb, pse3, n_res=N, cfg=cfg, batch=2, seed=4)
    c = protein.compose(pa, pb, pse3, n_res=N, cfg=cfg, batch=2, seed=5)
    torch.testing.assert_close(a["rigids"], b["rigids"], rtol=0, atol=0)
    assert (a["rigids"] - c["rigids"]).abs().max() > 1e-3
    assert a["atom37"].shape == (2, N, 37, 3) and a["traces"]["rigids"].shape == (2, 2, N, 7)
    torch.testing.assert_close(a["rigids"][..., :4].norm(dim=-1), torch.ones(2, N))
    assert backbone.to_pdb(a["atom37"][0]).count(" CA ") == N


def test_composition_config_defaults_match_jax():
    assert (dataclasses.asdict(protein.CompositionConfig())
            == dataclasses.asdict(jprotein.CompositionConfig()))


def test_cli_protein_end_to_end(tmp_path, capsys):
    from superdiff_tpu.cli import build_parser as jax_parser
    from superdiff_tpu_torch.cli import build_parser

    # the protein subcommand takes JAX's arguments, plus --device
    jax_opts = {a.dest: a.default for a in jax_parser()._subparsers._group_actions[0]
                .choices["protein"]._actions}
    opts = {a.dest: a.default for a in build_parser()._subparsers._group_actions[0]
            .choices["protein"]._actions}
    assert set(opts) - set(jax_opts) == {"device"} and set(jax_opts) <= set(opts)
    assert all(opts[k] == v for k, v in jax_opts.items())
    assert opts["device"] == "cuda"

    from superdiff_tpu_torch import cli

    out = tmp_path / "run"
    cli.main(["protein", "--device", "cpu", "--length", "8", "--num_t", "3",
              "--out_dir", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["length"] == 8 and 0.0 <= line["kappa_trans_last"] <= 1.0
    pdb = (out / "len_8_seed_0.pdb").read_text()
    assert pdb.count(" CA ") == 8 and pdb.endswith("END\n")
    assert json.loads((out / "config_snapshot.json").read_text())["device"] == "cpu"


@pytest.mark.parametrize("arg", [["--mpnn_ckpt", "mpnn.pt"], ["--esm_dir", "esm2"],
                                 ["--seq_nums", "0"]])
def test_cli_protein_struct2seq_options_raise(tmp_path, arg):
    """The struct2seq options (JAX's arguments) are checked before anything
    runs: a ProteinMPNN file or ESM2 directory that is not there, or no
    sequence per call, ends the command with its message. (The options'
    run with a struct2seq Proteus checkpoint: test_torch_struct2seq.py.)"""
    from superdiff_tpu_torch import cli

    with pytest.raises(SystemExit, match=arg[0]):
        cli.main(["protein", "--device", "cpu", "--out_dir", str(tmp_path / "run"),
                  *[str(tmp_path / a) if a in ("mpnn.pt", "esm2") else a for a in arg]])
    assert not (tmp_path / "run").exists()
