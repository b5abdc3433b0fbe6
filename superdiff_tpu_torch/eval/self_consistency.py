"""Protein self-consistency evaluation chain: inverse-fold -> refold -> score.

(Port of ``superdiff_tpu/eval/self_consistency.py``: ESMFold runs on
``device``, the card unless the caller passes the CPU.)

Rebuild of ``applications/proteins/evaluation/run_self_consistency.py``:
for each designed backbone, (1) ProteinMPNN proposes sequences (external CLI,
subprocess with bounded retry — ``run_self_consistency.py:255-288``),
(2) ESMFold refolds each sequence (external model, gated), (3) scTM/scRMSD
between design and refold are computed with the self-contained metrics in
``struct_metrics.py``, and rows accumulate into ``sc_results.csv``.

Both external stages are *gated*: this environment ships neither
ProteinMPNN weights nor ESMFold. The chain degrades gracefully —
``run_self_consistency`` reports which stages ran; scoring utilities are
fully functional given any (design, refold) coordinate pair, so plugging the
real binaries in requires only paths.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .struct_metrics import aligned_rmsd, ca_ca_clashes, secondary_structure_fractions, tm_score


@dataclasses.dataclass
class SelfConsistencyConfig:
    seqs_per_backbone: int = 8  # sc_config/inference.yaml:20
    max_retries: int = 5  # retry bound (run_self_consistency.py:274-288)
    protein_mpnn_cmd: Optional[str] = None  # e.g. "python protein_mpnn_run.py"
    designability_rmsd: float = 2.0  # scRMSD < 2A threshold (proteins/README.md:99)
    retry_delay: float = 1.0  # seconds between MPNN retries


def run_subprocess_with_retry(
    cmd: Sequence[str], max_retries: int, log=print, delay: float = 1.0
) -> int:
    """Bounded-retry subprocess runner (the reference's only fault-tolerance
    mechanism for the MPNN stage). Returns the number of attempts used."""
    for attempt in range(max_retries):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            return attempt + 1
        log(f"attempt {attempt + 1}/{max_retries} failed: {proc.stderr[-400:]}")
        time.sleep(delay)
    raise RuntimeError(f"command failed after {max_retries} retries: {cmd}")


def inverse_fold(
    pdb_path: str, cfg: SelfConsistencyConfig
) -> Optional[tuple[List[str], int]]:
    """ProteinMPNN stage; None when the external CLI is unavailable,
    otherwise (designed sequences, subprocess attempts used)."""
    if not cfg.protein_mpnn_cmd:
        return None
    out_dir = pdb_path + ".mpnn"
    os.makedirs(out_dir, exist_ok=True)
    cmd = cfg.protein_mpnn_cmd.split() + [
        "--pdb_path", pdb_path,
        "--out_folder", out_dir,
        "--num_seq_per_target", str(cfg.seqs_per_backbone),
        "--sampling_temp", "0.1",
        "--seed", "38",
        "--batch_size", "1",
    ]
    attempts = run_subprocess_with_retry(
        cmd, cfg.max_retries, delay=cfg.retry_delay
    )
    fasta_dir = os.path.join(out_dir, "seqs")
    seqs: List[str] = []
    for fname in sorted(os.listdir(fasta_dir)) if os.path.isdir(fasta_dir) else []:
        with open(os.path.join(fasta_dir, fname)) as f:
            seqs += [l.strip() for l in f if l.strip() and not l.startswith(">")]
    return seqs[1:], attempts  # first record is the input sequence


def get_esmfold_refolder(device="cuda") -> Optional[Callable[[str], np.ndarray]]:
    """Returns refold(sequence) -> CA coords (L, 3), ESMFold on ``device``,
    or None when ESMFold weights are unavailable (no egress here)."""
    try:
        import torch
        from transformers import AutoTokenizer, EsmForProteinFolding

        try:
            tok = AutoTokenizer.from_pretrained("facebook/esmfold_v1", local_files_only=True)
            model = EsmForProteinFolding.from_pretrained("facebook/esmfold_v1", local_files_only=True)
        except Exception:
            from ..utils.hub import allow_hub_download

            if not allow_hub_download():
                return None  # offline: fail fast to the gated-skip path
            tok = AutoTokenizer.from_pretrained("facebook/esmfold_v1")
            model = EsmForProteinFolding.from_pretrained("facebook/esmfold_v1")
        model = model.to(device).eval()
    except Exception:
        return None

    def refold(seq: str) -> np.ndarray:
        ids = tok([seq], return_tensors="pt", add_special_tokens=False)["input_ids"]
        with torch.no_grad():
            out = model(ids.to(device))
        pos = out["positions"][-1, 0]  # (L, 37?, 3) atom14
        return pos[:, 1].float().cpu().numpy()  # CA

    return refold


def score_pair(design_ca: np.ndarray, refold_ca: np.ndarray) -> dict:
    """scTM/scRMSD + structural context for one (design, refold) pair."""
    return {
        "tm_score": tm_score(refold_ca, design_ca),
        "rmsd": aligned_rmsd(refold_ca, design_ca),
        "clashes": ca_ca_clashes(design_ca),
        **{f"ss_{k}": v for k, v in secondary_structure_fractions(design_ca).items()},
    }


def run_self_consistency(
    design_ca: np.ndarray,
    pdb_path: str,
    cfg: SelfConsistencyConfig = SelfConsistencyConfig(),
    csv_path: Optional[str] = None,
    refolder: Optional[Callable[[str], np.ndarray]] = None,
) -> dict:
    """Full chain for one backbone; skips unavailable external stages and
    reports what ran. Appends per-sequence rows to ``sc_results.csv``.

    ``refolder`` overrides the ESMFold stage (``get_esmfold_refolder``) —
    the seam that lets the whole subprocess-to-CSV chain run under test
    with a stub fold function and a mock MPNN CLI
    (``tests/test_self_consistency.py``), mirroring the reference chain at
    ``evaluation/run_self_consistency.py:246-349``."""
    result = {
        "pdb": pdb_path, "mpnn": False, "esmfold": False,
        "mpnn_attempts": 0, "rows": [],
    }
    folded = inverse_fold(pdb_path, cfg)
    if folded is None:
        return result
    seqs, result["mpnn_attempts"] = folded
    result["mpnn"] = True
    if refolder is None:
        refolder = get_esmfold_refolder()
    if refolder is None:
        return result
    result["esmfold"] = True
    rows = []
    for i, seq in enumerate(seqs[: cfg.seqs_per_backbone]):
        ca = refolder(seq)
        row = {"seq_idx": i, "sequence": seq, **score_pair(design_ca, ca)}
        rows.append(row)
    result["rows"] = rows
    result["designable"] = any(r["rmsd"] < cfg.designability_rmsd for r in rows)
    if csv_path and rows:
        import pandas as pd

        df = pd.DataFrame(rows)
        df.insert(0, "pdb", pdb_path)
        header = not os.path.exists(csv_path)
        df.to_csv(csv_path, mode="a", header=header, index=False)
    return result
