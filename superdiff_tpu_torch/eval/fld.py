"""Feature Likelihood Divergence (FLD): generalization-aware sample quality
(port of ``superdiff_tpu/eval/fld.py``; role parity with
``notebooks/eval_fld.ipynb``, the ``fld`` package over DINOv2 features).

A mixture of isotropic Gaussians is centred on the generated samples'
features, the per-centre bandwidths are fit by maximizing the train set's
likelihood, and the metric is the dimension-normalized negative
log-likelihood of the *test* set under that mixture: it penalizes poor
quality (test far from the centres) and memorization (bandwidths collapsing
onto train copies). Feature extraction is pluggable; the math below is
extractor-agnostic and runs on the card by default.

Bridge to the ``fld`` package's absolute values: the package reports the
same train-fit mixture's dimension-adjusted test NLL up to an affine
normalization fixed by its implementation, a model-independent constant
for a fixed extractor and dataset that cancels in every comparison the
reference's tables make. When the package is installed,
``fld_bridge_constant`` measures it once.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.float32).to(device)


def _pairwise_d2(x, centers, chunk: int = 1024, *, device="cuda") -> torch.Tensor:
    """Squared euclidean distances (len(x), len(centers)), chunked over x:
    ``|x|^2 - 2 x c^T + |c|^2`` as one float32 GEMM a chunk (as JAX forms
    it, outside any kernel), floored at 0."""
    x, centers = _tensor(x, device), _tensor(centers, device)
    c2 = torch.sum(centers**2, dim=-1)
    outs = [torch.sum(xb**2, dim=-1)[:, None] - 2.0 * (xb @ centers.T) + c2[None, :]
            for xb in torch.split(x, chunk)]
    return torch.clamp_min(torch.cat(outs, dim=0), 0.0)


def _mog_ll_from_d2(d2: torch.Tensor, log_var: torch.Tensor, d: int) -> torch.Tensor:
    """log (1/n) sum_i N(x; c_i, e^{log_var_i} I) given precomputed d2."""
    ll = -0.5 * d2 / torch.exp(log_var)[None] - 0.5 * d * (log_var[None] + math.log(2 * math.pi))
    return torch.logsumexp(ll, dim=-1) - math.log(d2.shape[-1])


def _logsumexp_gaussians(x, centers, log_var: torch.Tensor) -> torch.Tensor:
    """log (1/n) sum_i N(x; c_i, e^{log_var_i} I) for each row of x."""
    return _mog_ll_from_d2(_pairwise_d2(x, centers, device=log_var.device), log_var,
                           int(x.shape[-1]))


def _clip(lv: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    # jnp.clip's gradient: maximum / minimum, each splitting a tie evenly
    return torch.minimum(torch.maximum(lv, lo), hi)


def fit_mog_bandwidths(
    gen_feats,
    train_feats,
    n_steps: int = 200,
    lr: float = 0.1,
    d2: Optional[torch.Tensor] = None,
    *,
    device="cuda",
) -> np.ndarray:
    """Fit per-centre isotropic log-variances by maximizing the train set's
    log-likelihood (the fld package's mixture fit).

    Distances are computed once; the log-variances start at each centre's
    squared distance to its nearest train feature over the dimension, are
    clipped to ``[lv_floor, lv_ceil]`` (the data's own squared-distance
    range; the floor the smallest strictly positive one, so a memorized
    centre stays finite) before the loss and at the end, and take
    ``n_steps`` Adam steps written out as optax's ``adam(lr)`` computes them
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root, both moments
    bias-corrected by the update count)."""
    centers = _tensor(gen_feats, device)
    d = centers.shape[-1]
    if d2 is None:
        d2 = _pairwise_d2(train_feats, centers, device=device)
    f32 = dict(dtype=torch.float32, device=d2.device)
    pos = torch.where(d2 > 0, d2, torch.tensor(math.inf, **f32))
    finite_min = torch.min(pos)
    lv_floor = torch.log(torch.where(torch.isfinite(finite_min), finite_min,
                                     torch.tensor(1e-6, **f32)) / d)
    lv_ceil = torch.log(torch.clamp_min(torch.max(d2), 1e-6) / d) + 5.0
    lv = _clip(torch.log(torch.clamp_min(torch.min(d2, dim=0).values / d, 1e-20)),
               lv_floor, lv_ceil)
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu, nu = torch.zeros_like(lv), torch.zeros_like(lv)
    for count in range(1, n_steps + 1):
        lv_req = lv.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = -_mog_ll_from_d2(d2, _clip(lv_req, lv_floor, lv_ceil), d).mean()
            (g,) = torch.autograd.grad(loss, lv_req)
        with torch.no_grad():
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * g**2 + b2 * nu
            mu_hat = mu / (1 - torch.tensor(b1, **f32) ** count)
            nu_hat = nu / (1 - torch.tensor(b2, **f32) ** count)
            lv = lv + -lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return _clip(lv, lv_floor, lv_ceil).cpu().numpy()


def fld(gen_feats, train_feats, test_feats, n_steps: int = 200, *, device="cuda") -> float:
    """Dimension-normalized test NLL of the train-fit generated-sample
    mixture. Lower is better. Matches the fld package's construction up to
    its baseline-shift constant (see the module docstring). Features may be
    numpy arrays or tensors (DINOv2's stay on the card)."""
    log_var = fit_mog_bandwidths(gen_feats, train_feats, n_steps=n_steps, device=device)
    ll = _logsumexp_gaussians(test_feats, gen_feats, _tensor(log_var, device))
    return float(-ll.mean().item() / int(gen_feats.shape[-1]))


def fld_repeated(
    gen_feats,
    train_feats,
    test_feats,
    n_repeats: int = 10,
    subsample: Optional[int] = 10_000,
    seed: int = 0,
    *,
    device="cuda",
) -> Tuple[float, float]:
    """Mean +/- std over resampled subsets (the notebook's x10 protocol),
    the subsets drawn by the JAX module's ``np.random.default_rng(seed)``
    calls, so both packages score the same indices."""
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_repeats):
        idx = rng.choice(len(gen_feats), min(subsample or len(gen_feats), len(gen_feats)),
                         replace=False)
        vals.append(fld(gen_feats[idx], train_feats, test_feats, device=device))
    return float(np.mean(vals)), float(np.std(vals))


def fld_bridge_constant(gen_feats, train_feats, test_feats, *, device="cuda"
                        ) -> Optional[float]:
    """(package FLD) - (our fld) on the same features, when the ``fld``
    package is installed; None when it is absent."""
    try:
        from fld.metrics.FLD import FLD as _PkgFLD
    except ImportError:
        return None
    pkg = _PkgFLD().compute_metric(*(torch.as_tensor(np.asarray(a))
                                     for a in (train_feats, test_feats, gen_feats)))
    return float(pkg) - fld(gen_feats, train_feats, test_feats, device=device)


def get_dinov2_feature_fn(device="cuda") -> Optional[Callable]:
    """DINOv2 feature extractor (transformers) from local files only; None
    when the package or its weights are absent. The returned
    ``feature_fn(uint8_images, batch_size=64)`` gives the pooled features as
    a float32 tensor on ``device``."""
    try:
        from transformers import AutoImageProcessor, AutoModel

        proc = AutoImageProcessor.from_pretrained("facebook/dinov2-base", local_files_only=True)
        model = AutoModel.from_pretrained("facebook/dinov2-base", local_files_only=True)
    except (ImportError, OSError, ValueError):
        return None
    model = model.to(device).eval()

    def feature_fn(uint8_images, batch_size: int = 64) -> torch.Tensor:
        outs = []
        with torch.no_grad():
            for i in range(0, len(uint8_images), batch_size):
                inputs = proc(images=list(uint8_images[i:i + batch_size]), return_tensors="pt")
                outs.append(model(**inputs.to(device)).pooler_output.float())
        return torch.cat(outs, 0)

    return feature_fn
