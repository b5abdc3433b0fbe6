"""Executable 2-D superposition walkthrough (the Figure-2 reproduction; port
of ``examples/superposition_2d.py``, the reference's educational notebooks
``diffusion_edu.ipynb`` + ``superposition_edu.ipynb``).

Train two MLP score nets on disjoint 2-D mixtures (the "up" and "down"
pairs of four Gaussians), then compose them along one reverse trajectory
three ways: OR over the SDE (on the card through the captured step loop and
its ``fused_sde_step`` kernel), OR over the probability-flow ODE, and the
fixed average over the SDE; save the samples and, where matplotlib is
installed, a scatter figure.

Run:  python -m superdiff_tpu_torch.examples.superposition_2d [--outdir DIR]
      [--device cuda] [--n_iters 2000] [--n_steps 400] [--n_samples 512]

The helpers take injected draws (the tests hand in JAX's): the data
indices and normals of ``four_gaussians``, the batches and DSM normals of
``train_model``, the per-step normals or probes of ``sample``; whatever is
not given is drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dsm import make_dsm_loss
from ..core.schedules import VPSchedule
from ..core.superpose import SuperposeConfig, superpose
from ..models.ensemble import make_stacked_score_fn
from ..models.from_jax import init_like_flax_
from ..models.mlp import MLPScoreNet
from ..train.trainer import init_train_state, make_optimizer, make_train_step

SCHED = VPSchedule()
CENTERS = {"up": ((-2.0, 2.0), (2.0, 2.0)), "down": ((-2.0, -2.0), (2.0, -2.0))}
COMPOSITIONS = {
    "or_sde": dict(mode="sde", operator="or"),
    "or_ode": dict(mode="ode", operator="or"),
    "avg_sde": dict(mode="sde", operator="avg"),
}


def four_gaussians(n: int, which: str, *, generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                   device="cuda") -> torch.Tensor:
    """Two-of-four-Gaussians data: model 'up' sees the top modes, 'down' the
    bottom ones (the notebook's split); each point a centre (``idx``) plus
    0.3 times a unit normal (``noise``)."""
    centers = torch.tensor(CENTERS[which], dtype=torch.float32, device=device)
    if idx is None:
        idx = torch.randint(0, 2, (n,), generator=generator, device=device)
    if noise is None:
        noise = torch.randn((n, 2), generator=generator, device=device)
    return centers[torch.as_tensor(idx, device=device)] + 0.3 * torch.as_tensor(
        noise, dtype=torch.float32, device=device)


def train_model(which: str, n_iters: int = 2000, *, seed: int = 0, batch: int = 256,
                batches: Optional[Sequence[torch.Tensor]] = None,
                eps: Optional[Sequence[torch.Tensor]] = None, device="cuda",
                log=print) -> MLPScoreNet:
    """One MLP score net (hidden (128, 128)) trained by DSM (t_0 1e-3) with
    Adam at lr 2e-3 after a 50-update warmup, EMA 0.99, on ``batch`` points
    of ``which`` per iteration; returns the net with its trained (not EMA)
    parameters, as the toy runs use them. ``batches`` / ``eps``: the
    iterations' data and DSM normals, else drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = MLPScoreNet(hidden=(128, 128), out_dim=2).to(device)
    init_like_flax_(model, gen)
    opt = make_optimizer(lr=2e-3, warmup=50)
    state = init_train_state(gen, model, opt, ema_rate=0.99)
    step = make_train_step(opt, make_dsm_loss(lambda t, x, y, g: model(t, x), SCHED, t_0=1e-3))
    loss = torch.tensor(float("nan"))
    for i in range(n_iters):
        data = (torch.as_tensor(batches[i], device=device) if batches is not None
                else four_gaussians(batch, which, generator=gen, device=device))
        state, loss = step(state, {"image": data},
                           eps=None if eps is None else torch.as_tensor(eps[i], device=device))
    log(f"{which}: final DSM loss {loss.item():.3f}")
    return model.eval().requires_grad_(False)


def sample(models: Sequence[MLPScoreNet], name: str, x1: torch.Tensor, *, n_steps: int = 400,
           noise: Optional[Sequence[torch.Tensor]] = None,
           generator: Optional[torch.Generator] = None, capture: Optional[bool] = None):
    """Compose ``models`` from ``x1`` by one of :data:`COMPOSITIONS` over
    ``n_steps`` steps; returns (x_0, logq, nfe). ``noise``: the per-step
    unit normals (SDE) or Rademacher probes (ODE)."""
    cfg = SuperposeConfig(n_steps=n_steps, **COMPOSITIONS[name])
    return superpose(x1, make_stacked_score_fn(models), SCHED, cfg, n_models=len(models),
                     noise=noise, generator=generator, capture=capture)


def up_fraction(x0) -> float:
    """The share of samples in the upper half-plane (the 'up' model's modes)."""
    return float((torch.as_tensor(x0)[:, 1] > 0).float().mean())


def near_centre_fraction(x0, radius: float = 1.0) -> float:
    """The share of samples within ``radius`` of one of the four centres."""
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    c = torch.tensor(CENTERS["up"] + CENTERS["down"], dtype=torch.float32, device=x0.device)
    return float((torch.cdist(x0, c).min(dim=1).values <= radius).float().mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="superpose2d")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n_samples", type=int, default=512)
    ap.add_argument("--n_iters", type=int, default=2000)
    ap.add_argument("--n_steps", type=int, default=400)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    models = [train_model("up", args.n_iters, seed=0, device=dev),
              train_model("down", args.n_iters, seed=1, device=dev)]
    x1 = torch.randn((args.n_samples, 2), generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev)
    os.makedirs(args.outdir, exist_ok=True)
    results = {}
    for name in COMPOSITIONS:
        gen = torch.Generator(device=dev).manual_seed(8)
        x0, _, nfe = sample(models, name, x1, n_steps=args.n_steps, generator=gen)
        x0 = x0.cpu().numpy()
        results[name] = x0
        print(f"{name}: nfe={nfe}, up-mode fraction {up_fraction(x0):.2f}, "
              f"within 1 of a centre {near_centre_fraction(x0):.2f}", flush=True)
        np.save(os.path.join(args.outdir, f"samples_{name}.npy"), x0)

    try:
        import matplotlib
    except ImportError:
        print("(no figure: matplotlib is not installed)")
        return results
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(results), figsize=(4 * len(results), 4))
    for ax, (name, x0) in zip(np.atleast_1d(axes), results.items()):
        ax.scatter(x0[:, 0], x0[:, 1], s=4, alpha=0.5)
        ax.set_title(name)
        ax.set_xlim(-4, 4), ax.set_ylim(-4, 4)
    fig.savefig(os.path.join(args.outdir, "superposition_2d.png"), dpi=120)
    print(f"figure: {args.outdir}/superposition_2d.png")
    return results


if __name__ == "__main__":
    main()
