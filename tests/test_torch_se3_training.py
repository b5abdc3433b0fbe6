"""The port's SE(3) training (``train/se3_trainer.py``) and PDB data
(``data/pdb.py``) vs the JAX package, fp32 on the CPU.

* ``se3_forward_marginal`` on JAX's draws (its key split as JAX splits it:
  the translation normals, the IGSO(3) axis normals and inverse-CDF
  uniforms): noised frames, translation and rotation score targets within
  1e-5 of their largest magnitude (1e-4 for the rotation scores, read off
  the IGSO(3) tables by interpolation).
* ``make_se3_dsm_loss`` through a tiny ``IPAScoreNetwork`` carried from a
  Flax tree of draws, on JAX's t and marginal draws: the loss within 1e-5
  relative of JAX's.
* ``make_train_step`` with that loss: a tiny IPA net and a tiny FrameDiff
  net fit one batch (fixed draws), the loss falling over a few Adam steps,
  the EMA moving.
* PDB files written by the port's writer parse back to their backbone
  frames (translations the CA positions, rotations within the writer's
  idealised geometry), HETATM and altloc records are handled as JAX handles
  them, and the dataset filters by length and pads batches; one train step
  on a batch of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params, t

from superdiff_tpu.data import pdb as jpdb
from superdiff_tpu.models.protein.ipa import IPAConfig as JIPAConfig
from superdiff_tpu.models.protein.ipa import IPAScoreNetwork as JIPA
from superdiff_tpu.models.protein.r3 import R3Diffuser as JR3
from superdiff_tpu.models.protein.se3 import SE3Diffuser as JSE3
from superdiff_tpu.models.protein.so3 import SO3Diffuser as JSO3
from superdiff_tpu.train import se3_trainer as jse3t
from superdiff_tpu_torch.data import pdb
from superdiff_tpu_torch.models.from_jax import protein_net_from_flax
from superdiff_tpu_torch.models.protein import backbone, rigid
from superdiff_tpu_torch.models.protein import residue_constants as rc
from superdiff_tpu_torch.models.protein.framediff import FrameDiffConfig, FrameDiffScoreNetwork
from superdiff_tpu_torch.models.protein.ipa import IPAConfig, IPAScoreNetwork
from superdiff_tpu_torch.models.protein.r3 import R3Diffuser
from superdiff_tpu_torch.models.protein.se3 import SE3Diffuser
from superdiff_tpu_torch.models.protein.so3 import SO3Diffuser
from superdiff_tpu_torch.train import se3_trainer, trainer

torch.set_num_threads(2)
TABLES = dict(num_sigma=100, num_omega=200, L=200)
B, N = 2, 10


@pytest.fixture(scope="module")
def diffusers():
    return (JSE3(r3=JR3(), so3=JSO3(**TABLES)),
            SE3Diffuser(R3Diffuser(), SO3Diffuser(**TABLES, device="cpu")))


def rigids_np(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[..., :1])
    return np.concatenate([q, 6 * rng.standard_normal((b, n, 3)).astype(np.float32)], -1)


def marginal_draws(key, b=B, n=N):
    """JAX's draws of ``se3_forward_marginal(key, ...)``."""
    k_tr, k_ro = jax.random.split(key)
    k1, k2 = jax.random.split(k_ro)
    return {"trans": t(jax.random.normal(k_tr, (b, n, 3))),
            "axis": t(jax.random.normal(k1, (b, n, 3))), "u": t(jax.random.uniform(k2, (b, n)))}


def close(got, ref, tol, what=""):
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


def test_forward_marginal_matches_jax(diffusers):
    jdiff, pdiff = diffusers
    r0 = rigids_np(0)
    ts = np.float32([0.05, 0.7])
    key = jax.random.PRNGKey(1)
    ref = jax.jit(lambda k, r, s: jse3t.se3_forward_marginal(k, jdiff, r, s))(key, r0, ts)
    got = se3_trainer.se3_forward_marginal(pdiff, t(r0), t(ts), draws=marginal_draws(key))
    close(rigid.rigid_rotmat(got[0]), np.asarray(
        rigid.rigid_rotmat(t(ref[0]))), 1e-5, "rotmats")
    close(rigid.rigid_trans(got[0]), np.asarray(ref[0])[..., 4:], 1e-5, "trans_t")
    close(got[1], ref[1], 1e-5, "trans_score")
    close(got[2], ref[2], 1e-4, "rot_score")
    # drawn from a generator when no draws are given
    a = se3_trainer.se3_forward_marginal(pdiff, t(r0), t(ts),
                                         generator=torch.Generator().manual_seed(3))
    assert all(torch.isfinite(x).all() for x in a)


def batch_np(seed, b=B, n=N):
    mask = np.ones((b, n), np.float32)
    mask[1, -2:] = 0.0
    return {"rigids_0": rigids_np(seed, b, n), "res_mask": mask,
            "seq_idx": np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)}


def feats0(batch):
    return {"rigids_t": batch["rigids_0"], "res_mask": batch["res_mask"],
            "fixed_mask": np.zeros_like(batch["res_mask"]), "t": np.float32([0.5] * B),
            "seq_idx": batch["seq_idx"], "sc_ca_t": np.zeros((B, N, 3), np.float32)}


def test_dsm_loss_matches_jax(diffusers):
    jdiff, pdiff = diffusers
    batch = batch_np(2)
    jnet = JIPA(JIPAConfig.tiny(), jdiff)
    params = draw_params(jnet, feats0(batch), seed=4)
    pnet = protein_net_from_flax(IPAScoreNetwork(IPAConfig.tiny(), pdiff), params).eval()
    jloss = jse3t.make_se3_dsm_loss(lambda p, f, r: jnet.apply({"params": p}, f), jdiff)
    key = jax.random.PRNGKey(5)
    ref, _ = jax.jit(jloss)(key, params, jnp.float32(0.5), batch)
    k_t, k_fwd, _ = jax.random.split(key, 3)
    eps = {"t": t(jax.random.uniform(k_t, (B, 1), minval=0.01, maxval=1.0))[:, 0],
           **marginal_draws(k_fwd)}
    loss_fn = se3_trainer.make_se3_dsm_loss(pnet, pdiff)
    with torch.no_grad():
        got, state = loss_fn(torch.tensor(0.5), {k: t(v) for k, v in batch.items()}, eps=eps)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    assert state.item() == 0.5


@pytest.mark.parametrize("name", ["ipa", "framediff"])
def test_loss_falls_over_a_few_steps(diffusers, name):
    """One batch, the same draws every step: Adam at lr 1e-3 (warmup 1, so
    the first update has rate 0) brings the loss down; the EMA moves."""
    _, pdiff = diffusers
    torch.manual_seed(0)
    net = (IPAScoreNetwork(IPAConfig.tiny(), pdiff) if name == "ipa"
           else FrameDiffScoreNetwork(FrameDiffConfig.tiny(), score_calc=pdiff))
    from superdiff_tpu_torch.models.from_jax import init_like_flax_

    init_like_flax_(net, torch.Generator().manual_seed(6))
    batch = {k: t(v) for k, v in batch_np(7).items()}
    g = torch.Generator().manual_seed(8)
    eps = {"t": 0.3 + 0.4 * torch.rand(B, generator=g),
           **{k: v for k, v in marginal_draws(jax.random.PRNGKey(9)).items()}}
    opt = trainer.make_optimizer(lr=1e-3, warmup=1)
    state = trainer.init_train_state(torch.Generator().manual_seed(1), net, opt, ema_rate=0.9)
    ema0 = {k: v.clone() for k, v in state.params_ema.items()}
    step = trainer.make_train_step(opt, se3_trainer.make_se3_dsm_loss(net, pdiff))
    losses = []
    for _ in range(8):
        state, loss = step(state, batch, eps=eps)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    # the first update has rate 0; every later one lowers the loss
    assert losses[1] == losses[0] and all(np.diff(losses[1:]) < 0), losses
    assert losses[-1] < 0.9 * losses[0], losses
    assert state.step == 9
    assert any(not torch.equal(ema0[k], v) for k, v in state.params_ema.items())


def synth_pdb(n=24, seed=0):
    """A backbone PDB from the port's writer and the frames it came from."""
    g = torch.Generator().manual_seed(seed)
    quat = torch.randn((1, n, 4), generator=g)
    quat = quat / quat.norm(dim=-1, keepdim=True) * torch.sign(quat[..., :1])
    rigids = torch.cat([quat, 8.0 * torch.randn((1, n, 3), generator=g)], -1)
    return backbone.to_pdb(backbone.to_atom37(rigids)[0]), rigids[0].numpy()


def test_parse_roundtrip_backbone_frames():
    pdb_str, rigids_true = synth_pdb(24)
    prot = pdb.parse_pdb_string(pdb_str)
    ref = jpdb.parse_pdb_string(pdb_str)
    for f in ("aatype", "atom37", "atom37_mask", "residue_index", "chain_index", "b_factors"):
        np.testing.assert_array_equal(getattr(prot, f), getattr(ref, f))
    assert len(prot) == 24 and (prot.atom37_mask[:, rc.CA_IDX] == 1).all()
    rigids, exists = pdb.backbone_frames(prot.atom37, prot.atom37_mask)
    jr, je = jpdb.backbone_frames(ref.atom37, ref.atom37_mask)
    np.testing.assert_allclose(rigids, jr, atol=1e-5)
    np.testing.assert_array_equal(exists, je)
    assert (exists == 1).all()
    np.testing.assert_allclose(rigids[:, 4:], rigids_true[:, 4:], atol=2e-2)
    r_ours = rigid.rigid_rotmat(torch.as_tensor(rigids)).numpy()
    r_true = rigid.rigid_rotmat(torch.as_tensor(rigids_true)).numpy()
    rel = np.einsum("nij,nik->njk", r_true, r_ours)
    ang = np.arccos(np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1) / 2, -1, 1))
    assert ang.max() < 0.15, ang.max()


def test_parse_handles_hetatm_altloc_unknown():
    pdb_str, _ = synth_pdb(8, seed=1)
    lines = pdb_str.splitlines()
    ca = next(ln for ln in lines if ln[12:16].strip() == "CA")
    extra = [
        # a water and a ligand: skipped
        "HETATM  999  O   HOH A 900      1.000   2.000   3.000  1.00  0.00           O",
        # selenomethionine: read as MET, SE as SD
        "HETATM 1000  CA  MSE A  20      4.000   5.000   6.000  1.00  9.00           C",
        "HETATM 1001  SE  MSE A  20      4.500   5.500   6.500  1.00  9.00          SE",
        # an altloc B copy of a CA: skipped; an unknown residue name: UNK
        ca[:16] + "B" + ca[17:30] + "  99.000  99.000  99.000" + ca[54:],
        "ATOM   1002  CA  XYZ A  21      7.000   8.000   9.000  1.00  0.00           C",
    ]
    text = "\n".join(lines[:-1] + extra + lines[-1:]) + "\n"
    prot, ref = pdb.parse_pdb_string(text), jpdb.parse_pdb_string(text)
    assert len(prot) == 10
    for f in ("aatype", "atom37", "atom37_mask", "residue_index", "b_factors"):
        np.testing.assert_array_equal(getattr(prot, f), getattr(ref, f))
    assert prot.aatype[8] == rc.resname_to_idx["MET"] and prot.aatype[9] == rc.restype_num
    assert prot.atom37_mask[8, rc.atom_order["SD"]] == 1.0
    assert prot.atom37[0, rc.CA_IDX, 0] != 99.0


def test_dataset_filters_pads_and_trains(tmp_path, diffusers):
    _, pdiff = diffusers
    for i, n in enumerate((8, 30, 44)):
        (tmp_path / f"s{i}.pdb").write_text(synth_pdb(n, seed=i)[0])
    (tmp_path / "notes.txt").write_text("not a structure")
    ds = pdb.ProteinDataset.from_dir(str(tmp_path), pdb.ProteinDatasetConfig(min_len=20))
    jds = jpdb.ProteinDataset.from_dir(str(tmp_path), jpdb.ProteinDatasetConfig(min_len=20))
    assert len(ds) == len(jds) == 2 and ds.pad_to == jds.pad_to == 44
    batch, jbatch = ds.batch([0, 1]), jds.batch([0, 1])
    for k in batch:
        np.testing.assert_allclose(batch[k], jbatch[k], atol=1e-4)
    assert batch["res_mask"].sum() == 30 + 44
    np.testing.assert_allclose(np.linalg.norm(batch["rigids_0"][..., :4], axis=-1), 1.0,
                               atol=1e-4)
    assert len(list(ds.epoch(np.random.default_rng(0), 2))) == 1
    net = IPAScoreNetwork(IPAConfig.tiny(), pdiff)
    opt = trainer.make_optimizer(lr=1e-4, warmup=5)
    state = trainer.init_train_state(torch.Generator().manual_seed(1), net, opt)
    step = trainer.make_train_step(opt, se3_trainer.make_se3_dsm_loss(net, pdiff))
    for _ in range(2):
        state, loss = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert np.isfinite(loss.item())
    with pytest.raises(ValueError, match="no parseable"):
        pdb.ProteinDataset.from_dir(str(tmp_path), pdb.ProteinDatasetConfig(min_len=100))
