"""Designability and novelty evaluation for generated backbones.

(A copy of ``superdiff_tpu/eval/novelty.py``, which is numpy there too.)

Reference semantics (``applications/proteins/visualization/
novel_proteins.ipynb`` cells 1-4 and ``proteins/README.md:103-106``):

* designable = the best (minimum) self-consistency scRMSD over the
  ProteinMPNN->ESMFold refolds is < 2 A (DESIGNABILITY_RMSD_THRESH);
* novel = designable AND the max TM-score against the PDB (Foldseek
  easy-search) is below a threshold (the notebook filters
  ``novelty_tmscore < 0.3``).

Foldseek is an external binary (absent in this image) — the runner is
gated exactly like the reference's ProteinMPNN/ESMFold stages.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

DESIGNABILITY_RMSD_THRESH = 2.0  # novel_proteins.ipynb cell 1
NOVELTY_TM_THRESH = 0.3  # cell 4


def designability(sc_rows: Iterable[dict],
                  rmsd_thresh: float = DESIGNABILITY_RMSD_THRESH) -> dict:
    """Per-backbone designability from self-consistency rows.

    ``sc_rows``: dicts with at least {"pdb", "rmsd"} (the schema
    ``eval/self_consistency.py`` writes to sc_results.csv). Returns
    {"per_pdb": {pdb: {"min_rmsd", "designable"}}, "rate": float}.
    """
    best: Dict[str, float] = {}
    for row in sc_rows:
        pdb = row["pdb"]
        r = float(row["rmsd"])
        best[pdb] = min(best.get(pdb, float("inf")), r)
    per_pdb = {
        p: {"min_rmsd": r, "designable": r < rmsd_thresh} for p, r in best.items()
    }
    n = len(per_pdb)
    rate = sum(v["designable"] for v in per_pdb.values()) / n if n else 0.0
    return {"per_pdb": per_pdb, "rate": rate, "n": n}


def run_foldseek(pdb_dir: str, database: str,
                 foldseek_cmd: str = "foldseek") -> Optional[Dict[str, float]]:
    """Max TM-score per query structure vs a Foldseek database.

    Runs ``foldseek easy-search`` with alntmscore output; returns
    {query_filename: max_tm} or None when the binary is unavailable
    (gated, like the reference's external tools)."""
    if shutil.which(foldseek_cmd) is None:
        return None
    with tempfile.TemporaryDirectory() as tmp:
        aln = os.path.join(tmp, "aln.tsv")
        cmd = [
            foldseek_cmd, "easy-search", pdb_dir, database, aln,
            os.path.join(tmp, "fs_tmp"),
            "--format-output", "query,target,alntmscore",
        ]
        rc = subprocess.run(cmd, capture_output=True).returncode
        if rc != 0 or not os.path.exists(aln):
            return None
        with open(aln) as f:
            return parse_foldseek_tsv(f.read())


def parse_foldseek_tsv(text: str) -> Dict[str, float]:
    """Parse `query target alntmscore` rows into per-query max TM."""
    out: Dict[str, float] = defaultdict(float)
    for line in text.splitlines():
        parts = line.split("\t")
        if len(parts) < 3:
            continue
        try:
            tm = float(parts[2])
        except ValueError:
            continue
        out[parts[0]] = max(out[parts[0]], tm)
    return dict(out)


def novelty_table(
    sc_rows: Iterable[dict],
    novelty_tm: Optional[Dict[str, float]] = None,
    rmsd_thresh: float = DESIGNABILITY_RMSD_THRESH,
    tm_thresh: float = NOVELTY_TM_THRESH,
) -> dict:
    """Combined designability + novelty summary.

    ``novelty_tm``: {pdb (path or basename): max TM vs PDB} from
    :func:`run_foldseek`; None marks novelty as unavailable (gated)."""
    d = designability(sc_rows, rmsd_thresh)
    rows: List[dict] = []
    n_novel = 0
    n_scored = 0
    for pdb, info in d["per_pdb"].items():
        row = {"pdb": pdb, **info, "novelty_tmscore": None, "novel": None}
        if novelty_tm is not None:
            key = pdb if pdb in novelty_tm else os.path.basename(pdb)
            key = key if key in novelty_tm else os.path.splitext(
                os.path.basename(pdb))[0]
            if key in novelty_tm:
                tm = novelty_tm[key]
                row["novelty_tmscore"] = tm
                row["novel"] = bool(info["designable"] and tm < tm_thresh)
                n_scored += 1
                n_novel += row["novel"]
        rows.append(row)
    return {
        "rows": rows,
        "designability_rate": d["rate"],
        "novelty_rate": (n_novel / n_scored) if n_scored else None,
        "n": d["n"],
    }
