"""The port's protein evaluation (``eval/{struct_metrics, self_consistency,
novelty, embed_viz}.py``) vs the JAX package, on the CPU.

* The structure metrics (numpy in both packages) give JAX's values on the
  same backbones.
* ``tm_affinity``, batched torch here (a vmapped jitted Kabsch + TM in
  JAX), within 1e-5 of JAX's matrix over backbones of unequal lengths, and
  the structure map built on it.
* The gated stages: without local ESMFold weights the refolder is None (no
  download is tried); the self-consistency chain runs through a stand-in
  ProteinMPNN command (failing once, so the retry path runs) and a
  stand-in refolder into its CSV; ``run_foldseek`` is None without the
  binary and parses a stand-in binary's search.
"""

import csv
import os
import stat
import sys
import textwrap

import numpy as np
import pytest

from superdiff_tpu.eval import embed_viz as jembed
from superdiff_tpu.eval import struct_metrics as jsm
from superdiff_tpu_torch.eval import embed_viz, novelty, self_consistency, struct_metrics

AA = "ACDEFGHIKLMNPQRSTVWY"


def helix_ca(n=24, seed=0, rise=1.5):
    t = np.arange(n) * 100.0 * np.pi / 180.0
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), rise * np.arange(n)], -1)
    return ca + np.random.default_rng(seed).normal(size=ca.shape) * 0.05


def strand_ca(n=24, seed=0):
    ca = np.stack([3.3 * np.arange(n), 1.0 * (np.arange(n) % 2), 0.2 * np.arange(n)], -1)
    return ca + np.random.default_rng(seed).normal(size=ca.shape) * 0.05


def test_struct_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = helix_ca(30, 1)
    rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    b = a @ rot.T + 3.0 + rng.normal(size=a.shape) * 0.8
    for fn in ("aligned_rmsd", "tm_score_kabsch", "tm_score"):
        assert getattr(struct_metrics, fn)(a, b) == getattr(jsm, fn)(a, b), fn
    for r_p, r_j in zip(struct_metrics.kabsch(a, b), jsm.kabsch(a, b)):
        np.testing.assert_array_equal(r_p, r_j)
    for ca in (a, strand_ca(20), helix_ca(12, 2, rise=0.5)):
        assert struct_metrics.ca_ca_clashes(ca) == jsm.ca_ca_clashes(ca)
        assert struct_metrics.radius_of_gyration(ca) == jsm.radius_of_gyration(ca)
        assert (struct_metrics.secondary_structure_fractions(ca)
                == jsm.secondary_structure_fractions(ca))


@pytest.fixture(scope="module")
def families():
    return {"helix": [helix_ca(24 + 2 * i, seed=i) for i in range(4)],
            "strand": [strand_ca(22 + 3 * i, seed=10 + i) for i in range(4)]}


def test_tm_affinity_matches_jax(families):
    coords = [c for cs in families.values() for c in cs]
    got = embed_viz.tm_affinity(coords, batch_pairs=7, device="cpu")
    ref = jembed.tm_affinity(coords)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-5)
    np.testing.assert_array_equal(got, got.T)
    # the Kabsch TM of the numpy metric over the common prefix
    n = min(len(coords[0]), len(coords[5]))
    np.testing.assert_allclose(
        got[0, 5], struct_metrics.tm_score_kabsch(coords[0][:n], coords[5][:n]), atol=1e-4)


def test_structure_map_separates_families(families):
    out = embed_viz.structure_map(families, method="numpy", device="cpu")
    assert out["xy"].shape == (8, 2) and out["labels"][:4] == ["helix"] * 4
    within = out["affinity"][:4, :4].mean()
    across = out["affinity"][:4, 4:].mean()
    assert within > across


def test_esmfold_is_gated_without_local_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("SUPERDIFF_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    assert self_consistency.get_esmfold_refolder(device="cpu") is None


def _mock_mpnn(tmp_path, n_res):
    """A stand-in ProteinMPNN command: the first call fails, later calls write
    a FASTA whose first record is the input sequence."""
    marker = tmp_path / "mpnn_called"
    script = tmp_path / "protein_mpnn_run.py"
    script.write_text(textwrap.dedent(f"""\
        import argparse, os, sys, random
        p = argparse.ArgumentParser()
        for a in ("--pdb_path", "--out_folder", "--sampling_temp"):
            p.add_argument(a)
        for a in ("--num_seq_per_target", "--seed", "--batch_size"):
            p.add_argument(a, type=int)
        a = p.parse_args()
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").write("1")
            sys.exit(1)
        random.seed(a.seed)
        os.makedirs(os.path.join(a.out_folder, "seqs"), exist_ok=True)
        with open(os.path.join(a.out_folder, "seqs", "design.fa"), "w") as f:
            for k in range(a.num_seq_per_target + 1):
                f.write(f">s{{k}}\\n" + "".join(random.choice({AA!r}) for _ in range({n_res}))
                        + "\\n")
        """))
    return f"{sys.executable} {script}"


def test_self_consistency_chain_with_stand_ins(tmp_path):
    design = helix_ca(20)
    pdb = tmp_path / "design.pdb"
    pdb.write_text("END\n")
    cfg = self_consistency.SelfConsistencyConfig(seqs_per_backbone=3, retry_delay=0.0,
                                                 protein_mpnn_cmd=_mock_mpnn(tmp_path, 20))
    csv_path = str(tmp_path / "sc_results.csv")
    rng = np.random.default_rng(3)
    res = self_consistency.run_self_consistency(
        design, str(pdb), cfg, csv_path=csv_path,
        refolder=lambda seq: design + rng.normal(size=design.shape) * 0.3)
    assert res["mpnn"] and res["esmfold"] and res["mpnn_attempts"] == 2
    assert len(res["rows"]) == 3 and res["designable"]
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and all(float(r["rmsd"]) < 2.0 for r in rows)
    table = novelty.novelty_table(rows, {"design": 0.2})
    assert table["designability_rate"] == 1.0 and table["novelty_rate"] == 1.0
    # without a ProteinMPNN command nothing runs
    off = self_consistency.run_self_consistency(design, str(pdb))
    assert not off["mpnn"] and off["rows"] == []


def test_foldseek_runs_only_where_the_binary_exists(tmp_path, monkeypatch):
    assert novelty.run_foldseek(str(tmp_path), "db", foldseek_cmd="foldseek-absent") is None
    assert embed_viz.foldseek_affinity(str(tmp_path), foldseek_cmd="foldseek-absent") is None
    fake = tmp_path / "bin" / "foldseek"
    fake.parent.mkdir()
    # easy-search QUERY DB OUT TMP ...: two hits of a.pdb, one of b.pdb
    fake.write_text("#!/bin/sh\nprintf 'a.pdb\\tx\\t0.42\\na.pdb\\ty\\t0.61\\nb.pdb\\tx\\t0.2\\n'"
                    " > \"$4\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    got = novelty.run_foldseek(str(tmp_path), "db")
    assert got == {"a.pdb": 0.61, "b.pdb": 0.2}
