"""FID / Inception Score evaluation (port of ``superdiff_tpu/eval/fid.py``).

Parity target: ``cifar/evaluation.py`` + ``notebooks/evals.ipynb``: pool3
features from InceptionV3, exact FID via a matrix square root, IS from the
logits head. The statistics and FID math is the port's own numpy/scipy
copy of the JAX module's; the features come from the port's InceptionV3
(``models/inception.py``) on the card. Without a weights file the
extractors are None (the JAX module's answer when it has no TF); there is
no TF fallback, and real weights are read only from a local file. The
exact matrix square root stays on the host (``evaluation.py:40``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def matrix_sqrt_spd(a: np.ndarray) -> np.ndarray:
    """Principal square root of a (near-)SPD matrix on host CPU (without
    ``sqrtm``'s ``disp`` argument, which newer SciPy versions drop)."""
    import scipy.linalg

    return np.real(scipy.linalg.sqrtm(a))


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray
) -> float:
    """Exact Fréchet distance between two Gaussians (evaluation.py:35-45)."""
    diff = mu1 - mu2
    covmean = matrix_sqrt_spd(cov1 @ cov2)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))


def feature_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, cov


def fid_from_features(ref_feats: np.ndarray, gen_feats: np.ndarray) -> float:
    m1, c1 = feature_statistics(ref_feats)
    m2, c2 = feature_statistics(gen_feats)
    return frechet_distance(m1, c1, m2, c2)


def fid_bootstrap(
    ref_feats: np.ndarray,
    gen_feats: np.ndarray,
    n_boot: int = 16,
    seed: int = 0,
) -> dict:
    """FID with a bootstrap 95% CI over the *generated* sample
    (VERDICT r3 weak #6: at n=1024 FID carries several points of sampling
    noise, so ordering claims need margins).

    The reference set is held fixed (it is the larger, common side of
    every comparison); each bootstrap resamples ``gen_feats`` with
    replacement.  Cost per resample is one covariance + one symmetric
    eigendecomposition instead of a non-symmetric ``sqrtm``:
    with ``A = C1^{1/2}`` precomputed once,
    ``tr sqrtm(C1 C2) = tr sqrtm(A C2 A) = sum sqrt(eigvalsh(A C2 A))``
    (similarity ``C1 C2 = A (A C2 A) A^{-1}`` — same spectrum, and
    ``A C2 A`` is SPD).

    Returns ``{"value", "boot_mean", "boot_std", "ci95": [lo, hi]}`` where
    ``value`` is the plain full-sample FID (identical to
    :func:`fid_from_features`) and the CI is the percentile interval of
    the bootstrap replicates.
    """
    rng = np.random.default_rng(seed)
    mu1, c1 = feature_statistics(ref_feats)
    a = matrix_sqrt_spd(c1)
    tr_c1 = float(np.trace(c1))

    def fd(g: np.ndarray) -> float:
        mu2, c2 = feature_statistics(g)
        diff = mu1 - mu2
        ev = np.linalg.eigvalsh(a @ c2 @ a)
        tr_sqrt = np.sqrt(np.clip(ev, 0.0, None)).sum()
        return float(diff @ diff + tr_c1 + np.trace(c2) - 2.0 * tr_sqrt)

    value = fd(gen_feats)
    n = len(gen_feats)
    boots = np.array(
        [fd(gen_feats[rng.integers(0, n, n)]) for _ in range(n_boot)]
    )
    lo, hi = np.percentile(boots, [2.5, 97.5])
    return {
        "value": value,
        "boot_mean": float(boots.mean()),
        "boot_std": float(boots.std(ddof=1)),
        "ci95": [float(lo), float(hi)],
    }


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS from class logits: exp(E KL(p(y|x) || p(y)))."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        py = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-10) - np.log(py + 1e-10))).sum(-1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def get_inception_feature_fn(weights_path: Optional[str] = None, device="cuda",
                             batch_size: int = 128) -> Optional[Callable]:
    """InceptionV3 pool3 extractor on ``device``: uint8 images (N, H, W, 3)
    -> (N, 2048) numpy. ``weights_path``: the JAX module's converted
    ``.npz`` or a Keras ``.h5``; None (or ``"imagenet"``, which would need a
    download) gives None."""
    if not weights_path or weights_path == "imagenet":
        return None
    from ..models import inception

    return inception.make_feature_fn(inception.load_params(weights_path),
                                     batch_size=batch_size, device=device)


def get_inception_logits_fn(weights_path: Optional[str] = None, device="cuda"
                            ) -> Optional[Callable]:
    """InceptionV3 class-logits extractor for IS (the reference computes IS
    from Inception's own final layer over pool3, ``evals.ipynb`` cell 13):
    ``logits_fn(uint8_images, batch_size=256) -> (N, 1000)``. None without
    a weights file or without a logits head in it."""
    if not weights_path or weights_path == "imagenet":
        return None
    from ..models import inception

    params = inception.load_params(weights_path)
    if "predictions" not in params:
        return None
    fns = {}  # one extractor per batch size

    def logits_fn(imgs, batch_size: int = 256):
        if batch_size not in fns:
            fns[batch_size] = inception.make_feature_fn(
                params, batch_size=batch_size, with_logits=True, device=device)
        return fns[batch_size](imgs)[1]

    return logits_fn


def load_dataset_stats(path: str) -> np.ndarray:
    """Load precomputed pool3 stats npz (``evaluation.py:47-57`` format)."""
    with open(path, "rb") as f:
        return np.load(f)["pool_3"]
