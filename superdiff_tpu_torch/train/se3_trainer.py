"""SE(3) denoising score matching for the protein score networks (port of
``superdiff_tpu/train/se3_trainer.py``).

The loss draws a time per sample and a forward-noised rigid per residue and
regresses both component scores, each normalised by its per-t score
scaling (the reference's loss weighting). It plugs into
``train.make_train_step`` as the CIFAR DSM loss does; the JAX package
shards the batch over a mesh, the port trains on one card.

The draws (t, the translation normals, the IGSO(3) axis normals and inverse
CDF uniforms) come from a ``torch.Generator`` or are handed in (the tests
give JAX's).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.protein import rigid
from ..models.protein.se3 import SE3Diffuser


def se3_forward_marginal(diffuser: SE3Diffuser, rigids_0: torch.Tensor, t: torch.Tensor, *,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[dict] = None):
    """``(rigids_t, trans_score, rot_score)``: rigids_t ~ p(.|rigids_0) at
    per-sample times ``t`` (B,) for ``rigids_0`` (B, N, 7), and the
    regression targets from the same score adapters the sampler uses.
    ``draws``: {"trans": (B, N, 3) normals, "axis": (B, N, 3) normals, "u":
    (B, N) uniforms}; what is missing comes from ``generator``."""
    draws = draws or {}
    dev = rigids_0.device
    t_res = t.reshape(t.shape + (1,) * (rigids_0.ndim - 1 - t.ndim))  # (B, 1)
    t_xyz = t_res[..., None]  # (B, 1, 1)
    r3 = diffuser.r3
    x_0s = r3.scale(rigid.rigid_trans(rigids_0))
    z = draws.get("trans")
    if z is None:
        z = torch.randn(x_0s.shape, generator=generator, device=dev)
    mean = torch.exp(-0.5 * torch.as_tensor(r3.marginal_b_t(t_xyz))) * x_0s
    x_t = mean + torch.sqrt(r3.conditional_var(t_xyz)) * z
    trans_score = r3.score(x_t, x_0s, t_xyz)
    rotvec = diffuser.so3.sample(t_res, rigids_0.shape[:-1], generator=generator,
                                 axis=draws.get("axis"), u=draws.get("u"))
    rot_0 = rigid.rigid_rotmat(rigids_0)
    rot_t = rot_0 @ rigid.rotvec_to_rotmat(rotvec)
    rot_score = diffuser.calc_rot_score(rot_t, rot_0, t_res)
    rigids_t = rigid.rigid(rigid.rotmat_to_quat(rot_t), r3.unscale(x_t))
    return rigids_t, trans_score, rot_score


def make_se3_dsm_loss(model: Callable[[dict], dict], diffuser: SE3Diffuser, *,
                      min_t: float = 0.01, trans_weight: float = 1.0,
                      rot_weight: float = 1.0):
    """The DSM loss for ``train.make_train_step``:
    ``loss_fn(sampler_state, batch, *, generator, eps=None) -> (loss,
    sampler_state)``. ``model(feats)`` returns ``trans_score`` /
    ``rot_score``; the batch is {"rigids_0": (B, N, 7), "res_mask": (B, N),
    "seq_idx": (B, N)}. ``eps`` optionally hands in the draws: {"t": (B,)
    in [min_t, 1), and :func:`se3_forward_marginal`'s}."""

    def loss_fn(sampler_state, batch, *, generator=None, eps: Optional[dict] = None):
        eps = eps or {}
        rigids_0, mask = batch["rigids_0"], batch["res_mask"]
        b = rigids_0.shape[0]
        t = eps.get("t")
        if t is None:
            t = min_t + (1.0 - min_t) * torch.rand((b,), generator=generator,
                                                   device=rigids_0.device)
        rigids_t, tgt_trans, tgt_rot = se3_forward_marginal(
            diffuser, rigids_0, t, generator=generator, draws=eps)
        feats = {"rigids_t": rigids_t, "res_mask": mask, "fixed_mask": torch.zeros_like(mask),
                 "t": t, "seq_idx": batch["seq_idx"],
                 "sc_ca_t": torch.zeros_like(rigid.rigid_trans(rigids_t))}
        out = model(feats)
        rot_scale, trans_scale = diffuser.score_scaling(t[:, None, None])
        m = mask[..., None]
        tr_err = ((out["trans_score"] - tgt_trans) / trans_scale) ** 2 * m
        ro_err = ((out["rot_score"] - tgt_rot) / rot_scale) ** 2 * m
        denom = torch.clamp(m.sum(), min=1.0)
        loss = trans_weight * tr_err.sum() / denom + rot_weight * ro_err.sum() / denom
        return loss, sampler_state

    return loss_fn
