"""Structure-embedding map of generated backbones (the protein_umap analog;
port of ``superdiff_tpu/eval/embed_viz.py``, the all-pairs TM-score as
batched torch on the card).

The reference's ``applications/proteins/visualization/protein_umap.ipynb``
concatenates the generated PDBs of each model (Proteus, FrameDiff, the
SuperDiff composition), runs an all-vs-all ``foldseek easy-search`` to get a
sparse TM-score affinity matrix, embeds it with UMAP, and scatter-plots the
samples colored by model — the figure showing the composition's samples
spanning/bridging the two parents' structure clusters
(``assets/umap_superdiff_or_w_proteins.jpg``).

The rebuild:

* **Affinity**: all-vs-all TM-score computed on device — a batched
  Kabsch superposition (``torch.linalg.svd`` / ``det`` of the 3x3
  covariances) over every pair, in chunks of pairs, instead of a foldseek
  subprocess. For unequal lengths the
  pair is truncated to the shorter backbone (a documented stand-in for
  foldseek's alignment; the reference's per-length sample series mostly
  compares equal lengths). When the foldseek binary IS present,
  :func:`foldseek_affinity` reproduces the notebook's exact search.
* **Embedding**: ``umap`` is not installed in this image; the default is
  spectral embedding of the TM-affinity graph (Laplacian eigenmaps — the
  same family of manifold layouts UMAP locally approximates), via sklearn
  when present, else a self-contained numpy ``eigh``. ``method='umap'``
  uses the real package when available.
* **Figure**: matplotlib scatter with the notebook's model colors.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

# the notebook's final palette (cell 10/14/16)
MODEL_COLORS = ("#BAB6EF", "#27A17D", "#FD8E39", "#7570B3", "#1B9E77")


def _pad_stack(coords: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length (L_i, 3) CA arrays into (N, Lmax, 3) + lengths."""
    lengths = np.array([len(c) for c in coords], np.int32)
    lmax = int(lengths.max())
    out = np.zeros((len(coords), lmax, 3), np.float32)
    for i, c in enumerate(coords):
        out[i, : len(c)] = np.asarray(c, np.float32)
    return out, lengths


def tm_affinity(coords: Sequence[np.ndarray], batch_pairs: int = 4096,
                device="cuda") -> np.ndarray:
    """All-vs-all Kabsch-TM affinity matrix, batched over pairs on ``device``
    (the card unless the caller passes the CPU).

    Each pair is truncated to the shorter length, Kabsch-superposed
    (masked), and scored with d0(L) = 1.24 (L-15)^(1/3) - 1.8 over the
    common prefix — identical math to ``struct_metrics.tm_score_kabsch``,
    i.e. the TM-score under the RMSD-optimal superposition. This is a
    *lower bound* on the TM-align-style optimized TM-score
    (``struct_metrics.tm_score``): the one-shot Kabsch fit keeps the
    all-pairs map one dense batched computation; the monotone bound
    preserves the neighborhood structure the embedding consumes.
    """
    import torch

    P, lengths = _pad_stack(coords)
    n = len(P)
    # Kabsch TM is symmetric: compute the upper triangle only and mirror
    iu, ju = np.triu_indices(n)
    Pd = torch.as_tensor(P, device=device)
    Ld = torch.as_tensor(lengths, device=device)
    pos = torch.arange(P.shape[1], device=device)
    out = np.empty(len(iu), np.float32)
    for s in range(0, len(iu), batch_pairs):
        i = torch.as_tensor(iu[s : s + batch_pairs], device=device)
        j = torch.as_tensor(ju[s : s + batch_pairs], device=device)
        a, b = Pd[i], Pd[j]  # (m, Lmax, 3)
        L = torch.minimum(Ld[i], Ld[j])
        mask = (pos[None] < L[:, None]).float()[..., None]  # (m, Lmax, 1)
        w = mask / torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        ac, bc = (a * w).sum(1, keepdim=True), (b * w).sum(1, keepdim=True)
        h = ((a - ac) * mask).transpose(1, 2) @ ((b - bc) * mask)  # (m, 3, 3)
        u, _, vt = torch.linalg.svd(h)
        d = torch.sign(torch.linalg.det(vt.transpose(1, 2) @ u.transpose(1, 2)))
        dd = torch.ones((len(d), 3), device=device)
        dd[:, 2] = d
        r = vt.transpose(1, 2) @ torch.diag_embed(dd) @ u.transpose(1, 2)
        diff = (a - ac) @ r.transpose(1, 2) + bc - b
        dist = torch.sqrt((diff**2).sum(-1) + 1e-12)
        lf = L.float()
        d0 = torch.clamp(1.24 * torch.clamp(lf - 15.0, min=0.0) ** (1.0 / 3.0) - 1.8, min=0.5)
        per = 1.0 / (1.0 + (dist / d0[:, None]) ** 2)
        tm = (per * mask[..., 0]).sum(1) / torch.clamp(lf, min=1.0)
        out[s : s + len(i)] = tm.cpu().numpy()
    M = np.zeros((n, n), np.float32)
    M[iu, ju] = out
    M[ju, iu] = out
    return M


def foldseek_affinity(
    pdb_dir: str, foldseek_cmd: str = "foldseek"
) -> Optional[Tuple[np.ndarray, list]]:
    """The notebook's exact affinity: all-vs-all ``foldseek easy-search`` of
    a PDB directory against itself (``protein_umap.ipynb`` cell 5). Returns
    (matrix, filenames) or None when the binary is unavailable (gated)."""
    if shutil.which(foldseek_cmd) is None:
        return None
    names = sorted(f for f in os.listdir(pdb_dir) if f.endswith(".pdb"))
    idx = {nm: k for k, nm in enumerate(names)}
    with tempfile.TemporaryDirectory() as tmp:
        aln = os.path.join(tmp, "aln.tsv")
        cmd = [
            foldseek_cmd, "easy-search", pdb_dir, pdb_dir, aln,
            os.path.join(tmp, "fs_tmp"),
            "--format-output", "query,target,alntmscore",
            "--tmscore-threshold", "0.3", "-v", "3",
        ]
        if subprocess.run(cmd, capture_output=True).returncode != 0:
            return None
        M = np.zeros((len(names), len(names)), np.float32)
        with open(aln) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3 or parts[0] not in idx or parts[1] not in idx:
                    continue
                try:
                    tm = float(parts[2])
                except ValueError:
                    continue
                M[idx[parts[0]], idx[parts[1]]] = tm
    return np.maximum(M, M.T), names


def _spectral_embed_numpy(affinity: np.ndarray, n_components: int = 2) -> np.ndarray:
    """Laplacian eigenmaps on the affinity graph (self-contained fallback)."""
    A = np.asarray(affinity, np.float64).copy()
    np.fill_diagonal(A, 0.0)
    deg = np.maximum(A.sum(1), 1e-12)
    Dm = 1.0 / np.sqrt(deg)
    Lsym = np.eye(len(A)) - (Dm[:, None] * A * Dm[None, :])
    vals, vecs = np.linalg.eigh(Lsym)
    # skip the trivial constant eigenvector
    emb = vecs[:, 1 : 1 + n_components] * Dm[:, None]
    return (emb / (np.abs(emb).max(0, keepdims=True) + 1e-12)).astype(np.float32)


def embed_2d(
    affinity: np.ndarray,
    method: str = "auto",
    n_neighbors: int = 20,
    seed: int = 32,
) -> np.ndarray:
    """2D layout of an affinity (similarity) matrix.

    method: 'umap' (notebook-exact, needs the package), 'spectral'
    (sklearn), 'numpy' (self-contained), or 'auto' = first available in
    that order. The notebook's UMAP hyperparameters (n_neighbors=20,
    min_dist=1, random_state=32, cell 7) are used when umap is present.
    """
    A = np.asarray(affinity, np.float32)
    order = {
        "auto": ("umap", "spectral", "numpy"),
        "umap": ("umap",),
        "spectral": ("spectral", "numpy"),
        "numpy": ("numpy",),
    }[method]
    for m in order:
        if m == "umap":
            try:
                import umap  # noqa: F401
            except ImportError:
                continue
            return np.asarray(
                umap.UMAP(
                    metric="euclidean", n_neighbors=n_neighbors, min_dist=1,
                    random_state=seed, low_memory=True,
                ).fit_transform(A),
                np.float32,
            )
        if m == "spectral":
            try:
                from sklearn.manifold import SpectralEmbedding
            except ImportError:
                continue
            k = min(n_neighbors, len(A) - 1)
            se = SpectralEmbedding(
                n_components=2, affinity="precomputed", random_state=seed,
                n_neighbors=k,
            )
            return np.asarray(se.fit_transform(A), np.float32)
        return _spectral_embed_numpy(A)
    raise RuntimeError(f"no embedding backend available for method={method!r}")


def plot_embedding(
    xy: np.ndarray,
    labels: Sequence[str],
    out_png: str,
    colors: Optional[Mapping[str, str]] = None,
    title: str = "",
) -> None:
    """Scatter the 2D layout colored by model label (notebook cell 7/10)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = list(labels)
    uniq = sorted(set(labels), key=labels.index)
    colors = dict(colors or {})
    for k, u in enumerate(uniq):
        colors.setdefault(u, MODEL_COLORS[k % len(MODEL_COLORS)])
    fig, ax = plt.subplots(figsize=(6, 5))
    for u in uniq:
        m = np.array([l == u for l in labels])
        ax.scatter(xy[m, 0], xy[m, 1], s=18, c=colors[u], label=u,
                   edgecolors="none", alpha=0.85)
    ax.legend(frameon=False)
    ax.set_xticks([])
    ax.set_yticks([])
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)


def structure_map(
    samples: Mapping[str, Sequence[np.ndarray]],
    out_png: Optional[str] = None,
    method: str = "auto",
    colors: Optional[Mapping[str, str]] = None,
    device="cuda",
) -> Dict[str, object]:
    """End-to-end analog of the notebook's ``make_umap``.

    samples: {model_name: [CA coords (L_i, 3), ...]} — e.g. the backbones
    of Proteus / FrameDiff / the OR composition from ``cli.py protein``
    output dirs (load via ``data.pdb.parse_pdb``).
    Returns {"xy", "labels", "affinity"} (the affinity on ``device``);
    writes the figure when ``out_png`` is given.
    """
    coords, labels = [], []
    for name, cs in samples.items():
        for c in cs:
            coords.append(np.asarray(c, np.float32))
            labels.append(name)
    A = tm_affinity(coords, device=device)
    xy = embed_2d(A, method=method)
    if out_png:
        plot_embedding(xy, labels, out_png, colors=colors)
    return {"xy": xy, "labels": labels, "affinity": A}
