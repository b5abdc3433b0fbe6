"""Structural metrics: Kabsch-aligned RMSD, TM-score, clash counting.

(A copy of ``superdiff_tpu/eval/struct_metrics.py``, which is numpy there too.)

Replaces the reference's tmtools/mdtraj dependencies
(``evaluation/analysis/metrics.py:44-73,127-130``) with self-contained numpy.
For self-consistency evaluation the designed and refolded backbones share a
sequence, so the residue correspondence is the identity; what still has to
be *optimized* is the superposition: tmtools' TM-align iteratively finds
the rigid transform that maximizes the TM-score itself, which on hinged or
partially-divergent structures is measurably higher than the TM-score
under the RMSD-optimal (Kabsch) transform — a systematic lower bound that
biases scTM near the 0.5 designability threshold. :func:`tm_score` runs
the TM-align-style iterative superposition; :func:`tm_score_kabsch` keeps
the one-shot Kabsch variant as the fast kernel for all-pairs affinity maps
(``eval/embed_viz.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def kabsch(P: np.ndarray, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal rotation R and translation t minimizing ||R P + t - Q||."""
    pc, qc = P.mean(0), Q.mean(0)
    P0, Q0 = P - pc, Q - qc
    H = P0.T @ Q0
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = qc - R @ pc
    return R, t


def aligned_rmsd(P: np.ndarray, Q: np.ndarray) -> float:
    """Kabsch-aligned RMSD over corresponding points (scRMSD,
    ``metrics.py:71-73``)."""
    R, t = kabsch(P, Q)
    diff = (P @ R.T + t) - Q
    return float(np.sqrt((diff**2).sum(-1).mean()))


def _d0(L: int) -> float:
    """d0(L) = 1.24 (L-15)^(1/3) - 1.8 (Zhang & Skolnick 2004)."""
    return max(1.24 * max(L - 15, 0) ** (1.0 / 3.0) - 1.8, 0.5)


def tm_score_kabsch(
    P: np.ndarray, Q: np.ndarray, l_target: int | None = None
) -> float:
    """TM-score under the one-shot Kabsch (RMSD-optimal) superposition.

    A *lower bound* on the TM-score (the RMSD-optimal transform is not the
    TM-optimal one); kept as the cheap kernel for all-pairs affinity maps
    where thousands of pairs are scored on-device (``eval/embed_viz.py``).
    Use :func:`tm_score` whenever the value itself is the metric.
    """
    L = l_target or len(P)
    R, t = kabsch(P, Q)
    d2 = (((P @ R.T + t) - Q) ** 2).sum(-1)
    return float(np.mean(1.0 / (1.0 + d2 / _d0(L) ** 2)))


def tm_score(P: np.ndarray, Q: np.ndarray, l_target: int | None = None) -> float:
    """TM-score maximized over superpositions, identity correspondence.

    The TMscore/TM-align procedure for a fixed residue correspondence
    (the tmtools call the reference makes at ``metrics.py:44-46``): seed
    superpositions from contiguous fragments (full chain, halves,
    quarters), then alternate (a) Kabsch on the residues currently within
    a distance cutoff of their partner with (b) re-selection under the new
    transform, until the selected set is a fixed point; take the best
    TM-score any iterate achieves over ALL residues. The d < d0-weighted
    subset iteration converges in a handful of steps; the fragment seeds
    let a hinge-bent pair lock onto its larger rigid domain instead of the
    RMSD compromise between domains (validated against constructed hinge
    pairs in ``tests/test_eval.py``).
    """
    P = np.asarray(P, np.float64)
    Q = np.asarray(Q, np.float64)
    n = len(P)
    L = l_target or n
    d0 = _d0(L)

    def tm_and_d2(R: np.ndarray, t: np.ndarray) -> Tuple[float, np.ndarray]:
        d2 = (((P @ R.T + t) - Q) ** 2).sum(-1)
        return float(np.mean(1.0 / (1.0 + d2 / d0**2))), d2

    best = tm_and_d2(*kabsch(P, Q))[0]
    if n < 4:
        return best
    frag_lens = sorted({n, max(n // 2, 4), max(n // 4, 4)}, reverse=True)
    for fl in frag_lens:
        for s in range(0, n - fl + 1, max(fl // 2, 1)):
            R, t = kabsch(P[s : s + fl], Q[s : s + fl])
            prev_sel = None
            for _ in range(30):
                tm, d2 = tm_and_d2(R, t)
                best = max(best, tm)
                # include residues near their partner; widen the cutoff
                # until the subset supports a rigid fit (TMscore's rule)
                d_cut = d0
                sel = d2 < d_cut**2
                while sel.sum() < 3 and d_cut < 8.0 * max(d0, 1.0):
                    d_cut += 0.5
                    sel = d2 < d_cut**2
                if sel.sum() < 3:
                    break
                if prev_sel is not None and np.array_equal(sel, prev_sel):
                    break
                prev_sel = sel
                R, t = kabsch(P[sel], Q[sel])
            best = max(best, tm_and_d2(R, t)[0])
    return best


def ca_ca_clashes(ca: np.ndarray, cutoff: float = 3.0) -> int:
    """Count non-bonded CA pairs (|i-j| >= 2) closer than ``cutoff`` angstrom
    (steric-clash screen, ``metrics.py:127-130`` role)."""
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1)
    iu = np.triu_indices(len(ca), k=2)  # skip self + bonded neighbors
    return int((d[iu] < cutoff).sum())


def radius_of_gyration(ca: np.ndarray) -> float:
    c = ca - ca.mean(0)
    return float(np.sqrt((c**2).sum(-1).mean()))


def secondary_structure_fractions(ca: np.ndarray) -> dict:
    """Coarse helix/strand fractions from CA virtual dihedrals (mdtraj-free
    stand-in for ``calc_mdtraj_metrics``): helices show ~50 deg CA dihedrals
    and ~5.5 A i,i+3 distances; strands are extended (> 9.8 A i,i+3)."""
    n = len(ca)
    if n < 4:
        return {"helix": 0.0, "strand": 0.0, "coil": 1.0}
    d13 = np.linalg.norm(ca[3:] - ca[:-3], axis=-1)
    helix = (d13 < 7.0).mean()
    strand = (d13 > 9.8).mean()
    return {
        "helix": float(helix),
        "strand": float(strand),
        "coil": float(1.0 - helix - strand),
    }
