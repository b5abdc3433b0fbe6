"""SE(3) protein-backbone SuperDiff: compose two score networks (port of
``superdiff_tpu/pipelines/protein.py``).

Two heterogeneous SE(3) score models sampled along ONE reverse trajectory,
with a separate mixing weight kappa and running Itô log-likelihood per
*component* (translations in R^3, rotations in SO(3)) and per model.
Operators: OR (softmax over running lls with per-component temperature /
bias) and AND (closed-form density equalization with a sigma-normalized
lift), plus fixed-kappa ``mixture`` and the single-model baselines.

Where JAX compiles the reverse loop into one ``lax.scan``, the port runs
an eager loop over the ``num_t - 1`` steps with the same carry (rigids, both
self-conditioning carries, the four running lls) and the same per-step
traces, stacked at the end. It runs on the diffuser's device (the card
unless the diffuser was built with ``device="cpu"``). JAX's threefry draws
cannot be reproduced: ``init_rigids`` and ``noise`` (the unscaled eps of
every step) are taken when given, else drawn from a ``torch.Generator``
seeded with ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import ito
from ..core.kappa import kappa_and_generic, kappa_or, normalized_log_sigma
from ..models.protein import rigid
from ..models.protein.backbone import to_atom37
from ..models.protein.se3 import SE3Diffuser


@dataclasses.dataclass(frozen=True)
class CompositionConfig:
    """The JAX package's defaults (the reference ``composition.yaml``)."""

    num_t: int = 500
    min_t: float = 0.002
    mixing_method: str = "composition"  # composition|mixture|baseline_a|baseline_b
    kappa_operator: str = "OR"  # OR | AND
    kappa_fixed: float = 0.5
    temp_trans: float = 1.0
    temp_rots: float = 1.0
    logp_trans: float = 0.0
    logp_rots: float = 0.0
    noise_scale: float = 0.1
    # the deterministic (probability-flow) sampler by default, as the reference
    stochastic: bool = False
    center: bool = True
    # fraction of steps on which the proteus-role model gets sequence
    # conditioning (struct2seq / ESM gating); 0 disables (the default)
    esm_rate: float = 0.0


ModelFn = Callable[[dict, torch.Tensor], dict]
# (feats, t) -> {"trans_score", "rot_score", "pred_trans", ...}


def _dx_ind_trans(f_x, score_b, beta_t, dt, noise):
    """The step model b alone would take (the AND kappa's reference point)."""
    return -dt * (f_x - 2.0 * beta_t * score_b) + noise


@torch.no_grad()
def compose(
    model_a: ModelFn,
    model_b: ModelFn,
    diffuser: SE3Diffuser,
    n_res: int,
    cfg: CompositionConfig = CompositionConfig(),
    batch: int = 1,
    init_rigids: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    res_mask: Optional[torch.Tensor] = None,
    fixed_mask: Optional[torch.Tensor] = None,
    sc_adapter_a: Optional[tuple] = None,
    sc_adapter_b: Optional[tuple] = None,
    seed: int = 0,
) -> dict:
    """Run the composed reverse trajectory; returns final rigids, atom37,
    the stacked per-step traces and the initial rigids.

    ``model_a`` plays the Proteus role (kappa weights it), ``model_b`` the
    FrameDiff role; both receive the same feature dict plus their own
    self-conditioning carry. ``init_rigids`` (batch, n_res, 7) and
    ``noise`` (num_t - 1, batch, n_res, 3), the unscaled eps of each step
    (one draw shared by both components, as the reference reuses it), are
    drawn from a ``torch.Generator`` seeded with ``seed`` when not given.

    ``sc_adapter_*``: optional ``(sc_init, sc_update)`` pair for the
    self-conditioning carry (``sc_init(init_rigids)``,
    ``sc_update(model_out)``); by default the carry is the predicted CA
    positions, fed as ``feats['sc_ca_t']``. A carry that is not a tensor
    reaches the model as ``feats['self_cond']``.
    """
    r3, so3 = diffuser.r3, diffuser.so3
    dev = diffuser.device
    f32 = dict(dtype=torch.float32, device=dev)
    reverse_steps = np.linspace(cfg.min_t, 1.0, cfg.num_t)[::-1]
    # the reference only steps while t > min_t: the strictly-greater prefix
    ts = torch.tensor(reverse_steps[:-1].copy(), **f32)
    dt = torch.tensor(1.0 / cfg.num_t, **f32)
    steps = cfg.num_t - 1

    gen = None
    if init_rigids is None or noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
    if init_rigids is None:
        init_rigids = diffuser.sample_ref(n_res, batch, generator=gen)
    if noise is None:
        noise = torch.randn((steps, batch, n_res, 3), generator=gen, device=dev)
    init_rigids = init_rigids.to(**f32)
    noise = noise.to(**f32)
    mask = torch.ones((batch, n_res), **f32) if res_mask is None else res_mask
    fmask = torch.zeros((batch, n_res), **f32) if fixed_mask is None else fixed_mask
    diffuse_mask = (1.0 - fmask) * mask
    seq_idx = torch.arange(n_res, device=dev)[None].expand(batch, n_res)

    def sigma_w_trans(t):
        sqrt_b = [torch.sqrt(torch.tensor(b, **f32)) for b in (r3.min_b, r3.max_b)]
        return normalized_log_sigma(torch.sqrt(r3.b_t(t)), *sqrt_b, n_res * 3)

    def sigma_w_rots(t):
        return normalized_log_sigma(so3.sigma(t), so3.min_sigma, so3.max_sigma, n_res * 3)

    # struct2seq gating: an evenly spaced subset of steps is flagged for the
    # proteus-role model
    num_esm = int(cfg.esm_rate * cfg.num_t)
    esm_flags = np.zeros(cfg.num_t, dtype=bool)
    if num_esm > 0:
        esm_flags[np.linspace(0, cfg.num_t - 1, num_esm, dtype=int)] = True

    def feats_for(rigids_t, t, sc, struct2seq=None):
        f = {
            "rigids_t": rigids_t,
            "res_mask": mask,
            "fixed_mask": fmask,
            "t": t.expand(batch),
            "seq_idx": seq_idx,
        }
        f["sc_ca_t" if isinstance(sc, torch.Tensor) else "self_cond"] = sc
        if struct2seq is not None:
            f["struct2seq"] = struct2seq
        return f

    zeros_ll = torch.zeros((batch,), **f32)
    sc0 = rigid.rigid_trans(init_rigids)
    sc_a = sc_adapter_a[0](init_rigids) if sc_adapter_a else sc0
    sc_b = sc_adapter_b[0](init_rigids) if sc_adapter_b else sc0
    rigids_t = init_rigids
    ll_a_tr = ll_b_tr = ll_a_ro = ll_b_ro = zeros_ll
    traces = {k: [] for k in ("kappa_trans", "kappa_rots", "ll_a_trans", "ll_b_trans",
                              "ll_a_rots", "ll_b_rots", "rigids")}
    for i in range(steps):
        t = ts[i]
        out_a = model_a(feats_for(rigids_t, t, sc_a, struct2seq=bool(esm_flags[i])), t)
        out_b = model_b(feats_for(rigids_t, t, sc_b), t)
        s_a_tr, s_b_tr = out_a["trans_score"], out_b["trans_score"]
        s_a_ro, s_b_ro = out_a["rot_score"], out_b["rot_score"]

        x_tr = r3.scale(rigid.rigid_trans(rigids_t))
        eps = cfg.noise_scale * noise[i]
        beta_tr = 0.5 * r3.diffusion_coef(t) ** 2
        beta_ro = 0.5 * so3.diffusion_coef(t) ** 2
        f_x = r3.drift_coef(x_tr, t)
        noise_tr = torch.sqrt(2.0 * beta_tr * dt) * eps
        noise_ro = torch.sqrt(2.0 * beta_ro * dt) * eps  # the same eps for both

        if cfg.mixing_method == "baseline_a":
            k_tr = k_ro = torch.ones((batch,), **f32)
        elif cfg.mixing_method == "baseline_b":
            k_tr = k_ro = torch.zeros((batch,), **f32)
        elif cfg.mixing_method == "mixture":
            k_tr = k_ro = torch.full((batch,), cfg.kappa_fixed, **f32)
        elif cfg.kappa_operator == "OR":
            k_tr = kappa_or(ll_a_tr, ll_b_tr, cfg.temp_trans, cfg.logp_trans)
            k_ro = kappa_or(ll_a_ro, ll_b_ro, cfg.temp_rots, cfg.logp_rots)
        else:  # AND
            dx_ind = _dx_ind_trans(f_x, s_b_tr, beta_tr, dt, noise_tr)
            k_tr = kappa_and_generic(s_a_tr, s_b_tr, dx_ind, f_x, beta_tr, dt, cfg.num_t,
                                     cfg.logp_trans, sigma_w_trans(t))
            dx_ind_ro = _dx_ind_trans(0.0, s_b_ro, beta_ro, dt, noise_ro)
            k_ro = kappa_and_generic(s_a_ro, s_b_ro, dx_ind_ro, 0.0, beta_ro, dt, cfg.num_t,
                                     cfg.logp_rots, sigma_w_rots(t))

        kt = k_tr[:, None, None]
        kr = k_ro[:, None, None]
        mixed_tr = s_b_tr + kt * (s_a_tr - s_b_tr)
        mixed_ro = s_b_ro + kr * (s_a_ro - s_b_ro)
        # EM steps in the scaled / tangent spaces
        dx_tr = -dt * (f_x - 2.0 * beta_tr * mixed_tr) + noise_tr
        dx_ro = dt * 2.0 * beta_ro * mixed_ro + noise_ro

        # divergence-free dll per model per component
        dll_tr = ito.dlogq_sde_r3(torch.stack([s_a_tr, s_b_tr]), x_tr, dx_tr, f_x,
                                  beta_tr, -0.5 * r3.b_t(t), dt)
        dll_ro = ito.dlogq_sde_driftless(torch.stack([s_a_ro, s_b_ro]), dx_ro, beta_ro, dt)
        ll_a_tr, ll_b_tr = ll_a_tr + dll_tr[:, 0], ll_b_tr + dll_tr[:, 1]
        ll_a_ro, ll_b_ro = ll_a_ro + dll_ro[:, 0], ll_b_ro + dll_ro[:, 1]

        rigids_t = diffuser.reverse(
            rigids_t, mixed_ro, mixed_tr, t, dt,
            stochastic=cfg.stochastic, noise_scale=cfg.noise_scale,
            diffuse_mask=diffuse_mask, center=cfg.center,
            dx_trans=dx_tr, dx_rots=dx_ro,
        )
        sc_a = sc_adapter_a[1](out_a) if sc_adapter_a else out_a["pred_trans"]
        sc_b = sc_adapter_b[1](out_b) if sc_adapter_b else out_b["pred_trans"]
        for k, v in (("kappa_trans", k_tr), ("kappa_rots", k_ro), ("ll_a_trans", ll_a_tr),
                     ("ll_b_trans", ll_b_tr), ("ll_a_rots", ll_a_ro), ("ll_b_rots", ll_b_ro),
                     ("rigids", rigids_t)):
            traces[k].append(v)

    return {
        "rigids": rigids_t,
        "atom37": to_atom37(rigids_t),
        "traces": {k: torch.stack(v) for k, v in traces.items()},
        "init_rigids": init_rigids,
    }
