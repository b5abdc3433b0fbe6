"""Invariant Point Attention score network for SE(3) backbone diffusion
(port of ``superdiff_tpu/models/protein/ipa.py``).

Per-residue node features and pairwise edge features flow through a stack
of IPA blocks that iteratively update a rigid frame per residue; the
network predicts clean rigids and psi torsions, and the scores come from
the diffuser's ``calc_rot_score`` / ``calc_trans_score``. With
``IPAConfig.framediff_like()`` it plays FrameDiff's role, with
``proteus_like()`` the higher-capacity, k-NN-local second model. The
modules carry the Flax module names, so ``models/from_jax.py`` carries a
Flax tree over mechanically. fp32 throughout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..from_jax import flax_zeros
from . import rigid


@dataclasses.dataclass(frozen=True)
class IPAConfig:
    node_dim: int = 256
    edge_dim: int = 128
    num_blocks: int = 4
    num_heads: int = 8
    scalar_qk: int = 16
    scalar_v: int = 16
    point_qk: int = 4
    point_v: int = 8
    index_embed_dim: int = 32
    max_rel_offset: int = 32
    distogram_bins: int = 22
    coordinate_scaling: float = 0.1
    # restrict attention to the k nearest residues by current CA distance
    # (Proteus-style locality); None = full attention (FrameDiff)
    local_attention_k: Optional[int] = None

    @staticmethod
    def framediff_like() -> "IPAConfig":
        return IPAConfig(num_blocks=4)

    @staticmethod
    def proteus_like() -> "IPAConfig":
        """Deeper / wider trunk with k-NN-local attention: the second
        architecture of a heterogeneous composition."""
        return IPAConfig(
            node_dim=384, edge_dim=160, num_blocks=6, num_heads=12,
            local_attention_k=32,
        )

    @staticmethod
    def tiny() -> "IPAConfig":
        return IPAConfig(node_dim=32, edge_dim=16, num_blocks=2, num_heads=2,
                         scalar_qk=4, scalar_v=4, point_qk=2, point_v=2,
                         index_embed_dim=8)


def sinusoidal(x: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, device=x.device)
                      / max(half - 1, 1))
    args = x[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Embedder(nn.Module):
    """Node: [t-embedding, fixed-mask flag, residue-index embedding]; edge:
    [relative-offset one-hot (clipped), t-embedding, self-conditioning CA
    distogram]."""

    def __init__(self, cfg: IPAConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.index_embed_dim
        self.node_proj = nn.Linear(2 * e + 1, cfg.node_dim)
        self.edge_proj = nn.Linear(2 * cfg.max_rel_offset + 1 + e + cfg.distogram_bins,
                                   cfg.edge_dim)

    def forward(self, seq_idx, t, fixed_mask, sc_ca_t):
        cfg = self.cfg
        b, n = seq_idx.shape
        t_emb = sinusoidal(t[:, None].expand(b, n), cfg.index_embed_dim)
        idx_emb = sinusoidal(seq_idx.float(), cfg.index_embed_dim)
        node = self.node_proj(torch.cat([t_emb, fixed_mask[..., None], idx_emb], dim=-1))

        rel = seq_idx[:, :, None] - seq_idx[:, None, :]
        rel = torch.clamp(rel, -cfg.max_rel_offset, cfg.max_rel_offset) + cfg.max_rel_offset
        rel_onehot = F.one_hot(rel.long(), 2 * cfg.max_rel_offset + 1).float()
        t_pair = t_emb[:, :, None, :].expand(b, n, n, cfg.index_embed_dim)
        d = torch.linalg.norm(sc_ca_t[:, :, None, :] - sc_ca_t[:, None, :, :], dim=-1)
        bins = torch.linspace(0.0, 40.0, cfg.distogram_bins - 1, device=d.device)
        disto = F.one_hot(torch.searchsorted(bins, d.contiguous()),
                          cfg.distogram_bins).float()
        edge = self.edge_proj(torch.cat([rel_onehot, t_pair, disto], dim=-1))
        return node, edge


class InvariantPointAttention(nn.Module):
    """AF2-style IPA, einsum-batched."""

    def __init__(self, cfg: IPAConfig):
        super().__init__()
        self.cfg = cfg
        h, sqk, sv, pqk, pv = (cfg.num_heads, cfg.scalar_qk, cfg.scalar_v,
                               cfg.point_qk, cfg.point_v)
        c = cfg.node_dim
        self.q = nn.Linear(c, h * sqk)
        self.k = nn.Linear(c, h * sqk)
        self.v = nn.Linear(c, h * sv)
        self.q_points = nn.Linear(c, h * pqk * 3)
        self.k_points = nn.Linear(c, h * pqk * 3)
        self.v_points = nn.Linear(c, h * pv * 3)
        self.point_weight = nn.Parameter(torch.zeros(h))
        self.edge_bias = nn.Linear(cfg.edge_dim, h)
        self.out_proj = nn.Linear(h * sv + h * pv * 4 + h * cfg.edge_dim, c)

    def forward(self, node, edge, rigids, mask):
        cfg = self.cfg
        h, sqk, sv, pqk, pv = (cfg.num_heads, cfg.scalar_qk, cfg.scalar_v,
                               cfg.point_qk, cfg.point_v)
        b, n, _ = node.shape
        rot = rigid.rigid_rotmat(rigids)  # (b, n, 3, 3)
        trans = rigid.rigid_trans(rigids)  # (b, n, 3)

        q = self.q(node).reshape(b, n, h, sqk)
        k = self.k(node).reshape(b, n, h, sqk)
        v = self.v(node).reshape(b, n, h, sv)

        def to_global(p):  # (b, n, h, P, 3)
            return torch.einsum("bnij,bnhpj->bnhpi", rot, p) + trans[:, :, None, None, :]

        qp = to_global(self.q_points(node).reshape(b, n, h, pqk, 3))
        kp = to_global(self.k_points(node).reshape(b, n, h, pqk, 3))
        vp = to_global(self.v_points(node).reshape(b, n, h, pv, 3))

        scalar_logits = torch.einsum("bqhc,bkhc->bhqk", q, k) * (sqk**-0.5)
        d2 = torch.sum((qp[:, :, None] - kp[:, None]) ** 2, dim=(-1, -2))  # (b, q, k, h)
        gamma = F.softplus(self.point_weight)
        point_logits = -0.5 * gamma[None, :, None, None] * d2.permute(0, 3, 1, 2)
        edge_logits = self.edge_bias(edge).permute(0, 3, 1, 2)
        logits = (scalar_logits + point_logits + edge_logits) / math.sqrt(3.0)
        neg = torch.finfo(logits.dtype).min
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg)
        if cfg.local_attention_k is not None and cfg.local_attention_k < n:
            # keep the k nearest keys per query by current CA distance: a
            # threshold at the k-th smallest distance, so ties all stay
            d_ca = torch.sum((trans[:, :, None, :] - trans[:, None, :, :]) ** 2, dim=-1)
            kth = torch.topk(d_ca, cfg.local_attention_k, dim=-1, largest=False,
                             sorted=True).values[..., -1:]
            logits = torch.where((d_ca <= kth)[:, None], logits, neg)
        attn = torch.softmax(logits, dim=-1)  # (b, h, q, k)

        o_scalar = torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, n, h * sv)
        o_pts_global = torch.einsum("bhqk,bkhpi->bqhpi", attn, vp)
        # global -> local frame of the query residue
        o_pts = torch.einsum("bnji,bnhpj->bnhpi", rot,
                             o_pts_global - trans[:, :, None, None, :])
        o_pts_norm = torch.linalg.norm(o_pts + 1e-8, dim=-1)
        o_edge = torch.einsum("bhqk,bqkc->bqhc", attn, edge).reshape(b, n, -1)
        out = torch.cat([o_scalar, o_pts.reshape(b, n, h * pv * 3),
                         o_pts_norm.reshape(b, n, h * pv), o_edge], dim=-1)
        return self.out_proj(out)


class IPAScoreNetwork(nn.Module):
    """Embed -> IPA blocks -> rigid updates -> (rot / trans scores from the
    predicted clean rigids, psi torsions). ``se3_diffuser`` supplies
    ``calc_rot_score`` / ``calc_trans_score``."""

    def __init__(self, cfg: IPAConfig, se3_diffuser):
        super().__init__()
        self.cfg = cfg
        self.se3_diffuser = se3_diffuser
        c, e = cfg.node_dim, cfg.edge_dim
        self.embedder = Embedder(cfg)
        for i in range(cfg.num_blocks):
            setattr(self, f"ipa_{i}", InvariantPointAttention(cfg))
            # Flax's LayerNorm default epsilon
            setattr(self, f"ipa_ln_{i}", nn.LayerNorm(c, eps=1e-6))
            setattr(self, f"trans_fc1_{i}", nn.Linear(c, c))
            setattr(self, f"trans_fc2_{i}", nn.Linear(c, c))
            setattr(self, f"trans_ln_{i}", nn.LayerNorm(c, eps=1e-6))
            setattr(self, f"bb_update_{i}", flax_zeros(nn.Linear(c, 6)))
            if i < cfg.num_blocks - 1:
                setattr(self, f"edge_trans_{i}", nn.Linear(e + 2 * c, e))
                setattr(self, f"edge_ln_{i}", nn.LayerNorm(e, eps=1e-6))
        self.psi_head = nn.Linear(c, 2)

    def forward(self, feats: dict) -> dict:
        cfg = self.cfg
        rigids_t = feats["rigids_t"]  # (b, n, 7), trans in angstroms
        mask = feats["res_mask"].float()
        fixed_mask = feats.get("fixed_mask")
        if fixed_mask is None:
            fixed_mask = torch.zeros_like(mask)
        t = feats["t"]  # (b,)
        sc_ca = feats.get("sc_ca_t")
        if sc_ca is None:
            sc_ca = torch.zeros_like(rigids_t[..., 4:])
        node, edge = self.embedder(feats["seq_idx"], t, fixed_mask, sc_ca)
        node = node * mask[..., None]
        pair_mask = mask[:, :, None] * mask[:, None, :]
        edge = edge * pair_mask[..., None]

        # scaled coordinates inside the trunk
        scale = cfg.coordinate_scaling
        curr = rigid.scale_trans(rigids_t, scale)
        upd_mask = (mask * (1.0 - fixed_mask))[..., None]
        for i in range(cfg.num_blocks):
            node = node + getattr(self, f"ipa_{i}")(node, edge, curr, mask)
            node = getattr(self, f"ipa_ln_{i}")(node)
            ff = getattr(self, f"trans_fc1_{i}")(node)
            node = node + getattr(self, f"trans_fc2_{i}")(F.relu(ff))
            node = getattr(self, f"trans_ln_{i}")(node)
            # backbone update: 6-dof delta in the local frame
            upd = getattr(self, f"bb_update_{i}")(node)
            rotvec, dtrans = upd[..., :3], upd[..., 3:]
            dtrans_global = torch.einsum("bnij,bnj->bni", rigid.rigid_rotmat(curr), dtrans)
            curr = rigid.rigid_compose_rotvec(curr, rotvec * upd_mask,
                                              dtrans_global * upd_mask)
            if i < cfg.num_blocks - 1:
                b, n = node.shape[:2]
                e_in = torch.cat([edge, node[:, :, None, :].expand(b, n, n, cfg.node_dim),
                                  node[:, None, :, :].expand(b, n, n, cfg.node_dim)], dim=-1)
                edge = getattr(self, f"edge_ln_{i}")(getattr(self, f"edge_trans_{i}")(e_in))

        pred_rigids = rigid.scale_trans(curr, 1.0 / scale)  # back to angstroms
        psi = self.psi_head(node)
        pred_rot = rigid.rigid_rotmat(pred_rigids)
        pred_trans = rigid.rigid_trans(pred_rigids)
        rot_score = self.se3_diffuser.calc_rot_score(
            rigid.rigid_rotmat(rigids_t), pred_rot, t[:, None])
        trans_score = self.se3_diffuser.calc_trans_score(
            rigid.rigid_trans(rigids_t), pred_trans, t[:, None, None])
        return {
            "rigids": pred_rigids,
            "rot_score": rot_score * mask[..., None],
            "trans_score": trans_score * mask[..., None],
            "psi": psi,
            "pred_trans": pred_trans,
            "pred_rotmats": pred_rot,
        }
