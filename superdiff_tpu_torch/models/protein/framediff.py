"""Checkpoint-faithful FrameDiff SE(3) score network (port of
``superdiff_tpu/models/protein/framediff.py``).

The modules carry the reference's own ``state_dict`` names (282 tensors at
the published config, ``tests/fixtures/framediff_state_dict_schema.json``),
so a reference checkpoint loads by ``load_state_dict``; the vestigial
``linear_rbf`` of every IPA and ``torsion_pred.linear_3`` exist, unused,
as in the reference. What it computes:

* Embedder: node / edge Linear-ReLU-Linear-ReLU-Linear-LayerNorm stacks
  over timestep, fixed-mask, index and self-conditioning distogram features.
* InvariantPointAttention with the reference's quirks: the split-stack
  [all-x, all-y, all-z] point layout, sqrt(1/(3 c_hidden)) / sqrt(1/3)
  logit scales, softplus head weights scaled by sqrt(1/(3 (P_q 9/2))), the
  o_feats order (scalar, x, y, z, norms, pair).
* The trunk: per block IPA -> post-LN -> [node ++ skip_embed(init)] ->
  post-norm transformer layers (written out: ``nn.TransformerEncoderLayer``
  in eval mode may take a fused path that rounds otherwise) -> post_tfmr ->
  StructureModuleTransition -> quaternion backbone update, edge transition
  on all but the last block; psi from TorsionAngles.
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
class FrameDiffConfig:
    """The reference ``model:`` config (config/base.yaml, resolved)."""

    node_embed_size: int = 256
    edge_embed_size: int = 128
    index_embed_size: int = 32
    embed_self_conditioning: bool = True
    num_bins: int = 22
    min_bin: float = 1e-5
    max_bin: float = 20.0
    c_hidden: int = 256
    c_skip: int = 64
    no_heads: int = 8
    no_qk_points: int = 8
    no_v_points: int = 12
    seq_tfmr_num_heads: int = 4
    seq_tfmr_num_layers: int = 2
    num_blocks: int = 4
    coordinate_scaling: float = 0.1

    @staticmethod
    def tiny() -> "FrameDiffConfig":
        return FrameDiffConfig(
            node_embed_size=32, edge_embed_size=16, index_embed_size=8,
            num_bins=22, c_hidden=16, c_skip=8, no_heads=2, no_qk_points=2,
            no_v_points=3, seq_tfmr_num_heads=2, seq_tfmr_num_layers=1,
            num_blocks=2,
        )

    @staticmethod
    def from_ckpt_conf(model_conf: dict) -> "FrameDiffConfig":
        """From a checkpoint-embedded ``conf.model`` dict."""
        embed = model_conf.get("embed", {})
        ipa = model_conf.get("ipa", {})
        return FrameDiffConfig(
            node_embed_size=int(model_conf.get("node_embed_size", 256)),
            edge_embed_size=int(model_conf.get("edge_embed_size", 128)),
            index_embed_size=int(embed.get("index_embed_size", 32)),
            embed_self_conditioning=bool(embed.get("embed_self_conditioning", True)),
            num_bins=int(embed.get("num_bins", 22)),
            min_bin=float(embed.get("min_bin", 1e-5)),
            max_bin=float(embed.get("max_bin", 20.0)),
            c_hidden=int(ipa.get("c_hidden", 256)),
            c_skip=int(ipa.get("c_skip", 64)),
            no_heads=int(ipa.get("no_heads", 8)),
            no_qk_points=int(ipa.get("no_qk_points", 8)),
            no_v_points=int(ipa.get("no_v_points", 12)),
            seq_tfmr_num_heads=int(ipa.get("seq_tfmr_num_heads", 4)),
            seq_tfmr_num_layers=int(ipa.get("seq_tfmr_num_layers", 2)),
            num_blocks=int(ipa.get("num_blocks", 4)),
            coordinate_scaling=float(ipa.get("coordinate_scaling", 0.1)),
        )


def timestep_embedding(t: torch.Tensor, dim: int, max_positions: int = 10_000):
    """``get_timestep_embedding``: t scaled by max_positions first; [sin, cos]."""
    tt = t * max_positions
    half = dim // 2
    emb = math.log(max_positions) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    args = tt.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def index_embedding(indices: torch.Tensor, embed_size: int, max_len: int = 2056):
    """``get_index_embedding`` (with its pi factor)."""
    k = torch.arange(embed_size // 2, dtype=torch.float32, device=indices.device)
    scale = indices[..., None].float() * math.pi / (max_len ** (2.0 * k / embed_size))
    return torch.cat([torch.sin(scale), torch.cos(scale)], dim=-1)


def calc_distogram(pos: torch.Tensor, min_bin: float, max_bin: float, num_bins: int):
    """Open-interval bin membership of pairwise distances."""
    d = torch.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], dim=-1)[..., None]
    lower = torch.linspace(min_bin, max_bin, num_bins, device=pos.device)
    upper = torch.cat([lower[1:], torch.full((1,), 1e8, device=pos.device)])
    return ((d > lower) * (d < upper)).to(pos.dtype)


def mlp3ln(c_in: int, width: int) -> nn.Sequential:
    """Linear-ReLU-Linear-ReLU-Linear-LayerNorm (the reference's indices
    0, 2, 4, 5)."""
    return nn.Sequential(nn.Linear(c_in, width), nn.ReLU(), nn.Linear(width, width),
                         nn.ReLU(), nn.Linear(width, width), nn.LayerNorm(width, eps=1e-5))


class Embedder(nn.Module):
    """``score_network.Embedder``."""

    def __init__(self, cfg: FrameDiffConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.index_embed_size
        self.node_embedder = mlp3ln(2 * e + 1, cfg.node_embed_size)
        edge_in = 2 * (e + 1) + e + (cfg.num_bins if cfg.embed_self_conditioning else 0)
        self.edge_embedder = mlp3ln(edge_in, cfg.edge_embed_size)

    def forward(self, seq_idx, t, fixed_mask, sc_ca_t):
        cfg = self.cfg
        b, n = seq_idx.shape
        t_emb = timestep_embedding(t, cfg.index_embed_size)[:, None, :].expand(b, n, -1)
        prot_t = torch.cat([t_emb, fixed_mask[..., None]], dim=-1)
        node_in = torch.cat([prot_t, index_embedding(seq_idx, cfg.index_embed_size)], dim=-1)
        # cross-concat of (t_emb, fixed) over pairs: (feat_i, feat_j)
        cross = torch.cat([prot_t[:, :, None, :].expand(b, n, n, -1),
                           prot_t[:, None, :, :].expand(b, n, n, -1)], dim=-1)
        rel = seq_idx[:, :, None] - seq_idx[:, None, :]
        pair_in = [cross, index_embedding(rel, cfg.index_embed_size)]
        if cfg.embed_self_conditioning:
            pair_in.append(calc_distogram(sc_ca_t, cfg.min_bin, cfg.max_bin, cfg.num_bins))
        return self.node_embedder(node_in), self.edge_embedder(torch.cat(pair_in, dim=-1))


class InvariantPointAttention(nn.Module):
    """``ipa_pytorch.InvariantPointAttention``, einsum form."""

    def __init__(self, cfg: FrameDiffConfig, inf: float = 1e5, eps: float = 1e-8):
        super().__init__()
        self.cfg, self.inf, self.eps = cfg, inf, eps
        c_s, c_z, ch = cfg.node_embed_size, cfg.edge_embed_size, cfg.c_hidden
        h, pq, pv = cfg.no_heads, cfg.no_qk_points, cfg.no_v_points
        self.head_weights = nn.Parameter(torch.full((h,), 0.541324854612918))
        self.linear_q = nn.Linear(c_s, h * ch)
        self.linear_kv = nn.Linear(c_s, 2 * h * ch)
        self.linear_q_points = nn.Linear(c_s, h * pq * 3)
        self.linear_kv_points = nn.Linear(c_s, h * (pq + pv) * 3)
        self.linear_b = nn.Linear(c_z, h)
        self.down_z = nn.Linear(c_z, c_z // 4)
        self.linear_out = flax_zeros(nn.Linear(h * (ch + 4 * pv + c_z // 4), c_s))
        # vestigial: in the reference's checkpoints, never used by its forward
        self.linear_rbf = nn.Linear(20, 1)

    def forward(self, s, z, r7, mask):
        cfg = self.cfg
        ch, h, pq, pv = cfg.c_hidden, cfg.no_heads, cfg.no_qk_points, cfg.no_v_points
        b, n, _ = s.shape
        q = self.linear_q(s).reshape(b, n, h, ch)
        kv = self.linear_kv(s).reshape(b, n, h, 2 * ch)
        k, v = kv[..., :ch], kv[..., ch:]

        def split_stack_points(x, npts):
            # the reference's layout: [all-x, all-y, all-z] thirds -> (b, n, h*npts, 3)
            hp = h * npts
            return torch.stack([x[..., :hp], x[..., hp:2 * hp], x[..., 2 * hp:]], dim=-1)

        r7b = r7[..., None, :]
        q_pts = rigid.rigid_apply(r7b, split_stack_points(self.linear_q_points(s), pq))
        q_pts = q_pts.reshape(b, n, h, pq, 3)
        kv_pts = rigid.rigid_apply(r7b, split_stack_points(self.linear_kv_points(s), pq + pv))
        kv_pts = kv_pts.reshape(b, n, h, pq + pv, 3)
        k_pts, v_pts = kv_pts[..., :pq, :], kv_pts[..., pq:, :]

        bias = self.linear_b(z)  # (b, n, n, h)
        a = torch.einsum("bihc,bjhc->bhij", q, k) * math.sqrt(1.0 / (3 * ch))
        a = a + math.sqrt(1.0 / 3) * bias.permute(0, 3, 1, 2)
        d2 = torch.sum((q_pts[:, :, None] - k_pts[:, None]) ** 2, dim=-1)  # (b, i, j, h, pq)
        hw = F.softplus(self.head_weights) * math.sqrt(1.0 / (3 * (pq * 9.0 / 2)))
        pt_att = torch.sum(d2 * hw[None, None, None, :, None], dim=-1) * (-0.5)
        a = a + pt_att.permute(0, 3, 1, 2)  # (b, h, i, j)
        square_mask = self.inf * (mask[:, None, :] * mask[:, :, None] - 1.0)
        a = torch.softmax(a + square_mask[:, None], dim=-1)

        o = torch.einsum("bhij,bjhc->bihc", a, v).reshape(b, n, h * ch)
        o_pt = torch.einsum("bhij,bjhpx->bihpx", a, v_pts)  # global frame
        # invert-apply: back to each query's local frame
        rot = rigid.rigid_rotmat(r7)
        trans = rigid.rigid_trans(r7)
        o_pt = torch.einsum("bnxy,bnhpx->bnhpy", rot, o_pt - trans[:, :, None, None, :])
        o_pt = o_pt.reshape(b, n, h * pv, 3)
        o_pt_norm = torch.sqrt(torch.sum(o_pt**2, dim=-1) + self.eps)
        pair_z = self.down_z(z)
        o_pair = torch.einsum("bhij,bijc->bihc", a, pair_z).reshape(b, n, -1)
        o_feats = torch.cat([o, o_pt[..., 0], o_pt[..., 1], o_pt[..., 2], o_pt_norm, o_pair],
                            dim=-1)
        return self.linear_out(o_feats)


class TorchSelfAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` (packed in-projection,
    ``out_proj``), computed as plain einsums."""

    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, pad_mask):
        b, n, d = x.shape
        h = self.nhead
        hd = d // h
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (u.reshape(b, n, h, hd) for u in qkv.chunk(3, dim=-1))
        logits = torch.einsum("bihc,bjhc->bhij", q, k) / math.sqrt(hd)
        logits = torch.where(pad_mask[:, None, None, :] > 0, logits,
                             torch.finfo(logits.dtype).min)
        o = torch.einsum("bhij,bjhc->bihc", torch.softmax(logits, dim=-1), v)
        return self.out_proj(o.reshape(b, n, d))


class TorchTransformerLayer(nn.Module):
    """``nn.TransformerEncoderLayer`` (batch_first, post-norm, ReLU, dropout
    0, feed-forward width d_model) with its parameter names."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.self_attn = TorchSelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, d_model)
        self.linear2 = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, pad_mask):
        x = self.norm1(x + self.self_attn(x, pad_mask))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class SeqTransformer(nn.Module):
    """``nn.TransformerEncoder``: its ``layers``."""

    def __init__(self, d_model: int, nhead: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TorchTransformerLayer(d_model, nhead)
                                    for _ in range(num_layers))

    def forward(self, x, pad_mask):
        for layer in self.layers:
            x = layer(x, pad_mask)
        return x


class StructureModuleTransition(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.linear_1 = nn.Linear(c, c)
        self.linear_2 = nn.Linear(c, c)
        self.linear_3 = flax_zeros(nn.Linear(c, c))
        self.ln = nn.LayerNorm(c, eps=1e-5)

    def forward(self, s):
        s0 = s
        s = F.relu(self.linear_2(F.relu(self.linear_1(s))))
        return self.ln(self.linear_3(s) + s0)


class EdgeTransition(nn.Module):
    def __init__(self, node_dim: int, edge_dim: int):
        super().__init__()
        bias_dim = node_dim // 2
        hidden = edge_dim + 2 * bias_dim
        self.initial_embed = nn.Linear(node_dim, bias_dim)
        self.trunk = nn.Sequential(nn.Linear(hidden, hidden), nn.ReLU(),
                                   nn.Linear(hidden, hidden), nn.ReLU())
        self.final_layer = flax_zeros(nn.Linear(hidden, edge_dim))
        self.layer_norm = nn.LayerNorm(edge_dim, eps=1e-5)

    def forward(self, node, edge):
        ne = self.initial_embed(node)
        b, n, _ = ne.shape
        e = torch.cat([edge, ne[:, :, None, :].expand(b, n, n, -1),
                       ne[:, None, :, :].expand(b, n, n, -1)], dim=-1)
        return self.layer_norm(self.final_layer(self.trunk(e) + e))


class TorsionAngles(nn.Module):
    """``linear_3`` is in the checkpoints but not used by the forward, as in
    the reference."""

    def __init__(self, c: int, num_torsions: int = 1, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.linear_1 = nn.Linear(c, c)
        self.linear_2 = nn.Linear(c, c)
        self.linear_3 = nn.Linear(c, c)
        self.linear_final = flax_zeros(nn.Linear(c, num_torsions * 2))

    def forward(self, s):
        s = self.linear_2(F.relu(self.linear_1(s))) + s
        raw = self.linear_final(s)
        denom = torch.sqrt(torch.clamp_min(torch.sum(raw**2, dim=-1, keepdim=True), self.eps))
        return raw, raw / denom


class BackboneUpdate(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.linear = flax_zeros(nn.Linear(c, 6))

    def forward(self, s):
        return self.linear(s)


def build_trunk(cfg: FrameDiffConfig, edge_transition) -> nn.ModuleDict:
    """The per-block modules of the IPA trunk, under the reference's names;
    ``edge_transition(b)`` builds block b's edge update (all but the last)."""
    c = cfg.node_embed_size
    d = c + cfg.c_skip
    trunk = nn.ModuleDict()
    for b in range(cfg.num_blocks):
        trunk[f"ipa_{b}"] = InvariantPointAttention(cfg)
        trunk[f"ipa_ln_{b}"] = nn.LayerNorm(c, eps=1e-5)
        trunk[f"skip_embed_{b}"] = flax_zeros(nn.Linear(c, cfg.c_skip))
        trunk[f"seq_tfmr_{b}"] = SeqTransformer(d, cfg.seq_tfmr_num_heads,
                                                cfg.seq_tfmr_num_layers)
        trunk[f"post_tfmr_{b}"] = flax_zeros(nn.Linear(d, c))
        trunk[f"node_transition_{b}"] = StructureModuleTransition(c)
        trunk[f"bb_update_{b}"] = BackboneUpdate(c)
        if b < cfg.num_blocks - 1:
            trunk[f"edge_transition_{b}"] = edge_transition(b)
    return trunk


def trunk_block(trunk: nn.ModuleDict, b: int, node, edge, curr, init_node, node_mask,
                diffuse_mask):
    """Block ``b`` of the shared trunk up to the backbone update; returns
    (node, curr)."""
    ipa_out = trunk[f"ipa_{b}"](node, edge, curr, node_mask)
    node = trunk[f"ipa_ln_{b}"](node + ipa_out * node_mask[..., None])
    skip = trunk[f"skip_embed_{b}"](init_node)
    tin = trunk[f"seq_tfmr_{b}"](torch.cat([node, skip], dim=-1), node_mask)
    node = node + trunk[f"post_tfmr_{b}"](tin)
    node = trunk[f"node_transition_{b}"](node) * node_mask[..., None]
    update = trunk[f"bb_update_{b}"](node * diffuse_mask[..., None])
    return node, rigid.rigid_compose_q_update(curr, update, diffuse_mask[..., None])


class IpaScore(nn.Module):
    def __init__(self, cfg: FrameDiffConfig):
        super().__init__()
        self.trunk = build_trunk(
            cfg, lambda b: EdgeTransition(cfg.node_embed_size, cfg.edge_embed_size))
        self.torsion_pred = TorsionAngles(cfg.node_embed_size)


class FrameDiffScoreNetwork(nn.Module):
    """``ScoreNetwork`` + ``IpaScore``: the full checkpoint-faithful model.
    ``score_calc`` (an ``SE3Diffuser``) turns the predicted rigids into
    rot / trans scores; None returns the rigids and psi only."""

    def __init__(self, cfg: FrameDiffConfig, score_calc: Optional[object] = None):
        super().__init__()
        self.cfg = cfg
        self.score_calc = score_calc
        self.embedding_layer = Embedder(cfg)
        self.score_model = IpaScore(cfg)

    def forward(self, feats: dict) -> dict:
        cfg = self.cfg
        bb_mask = feats["res_mask"].float()
        fixed_mask = feats["fixed_mask"].float()
        edge_mask = bb_mask[:, :, None] * bb_mask[:, None, :]
        diffuse_mask = (1.0 - fixed_mask) * bb_mask

        node, edge = self.embedding_layer(feats["seq_idx"], feats["t"], fixed_mask,
                                          feats["sc_ca_t"])
        edge = edge * edge_mask[..., None]
        init_node = node * bb_mask[..., None]
        node = init_node * bb_mask[..., None]

        init_rigids = feats["rigids_t"].float()
        scale = cfg.coordinate_scaling
        curr = rigid.scale_trans(init_rigids, scale)
        trunk = self.score_model.trunk
        for b in range(cfg.num_blocks):
            node, curr = trunk_block(trunk, b, node, edge, curr, init_node, bb_mask,
                                     diffuse_mask)
            if b < cfg.num_blocks - 1:
                edge = trunk[f"edge_transition_{b}"](node, edge) * edge_mask[..., None]

        _, psi = self.score_model.torsion_pred(node)
        # fixed residues keep their ground-truth psi
        if "torsion_angles_sin_cos" in feats:
            gt_psi = feats["torsion_angles_sin_cos"][..., 2, :]
            psi = (1.0 - fixed_mask[..., None]) * psi + fixed_mask[..., None] * gt_psi

        pred_rigids = rigid.scale_trans(curr, 1.0 / scale)
        out = {
            "rigids": pred_rigids,
            "psi": psi,
            "pred_trans": rigid.rigid_trans(pred_rigids),
            "pred_rotmats": rigid.rigid_rotmat(pred_rigids),
        }
        if self.score_calc is not None:
            t = feats["t"]
            rot_score = self.score_calc.calc_rot_score(
                rigid.rigid_rotmat(init_rigids), out["pred_rotmats"], t[:, None])
            trans_score = self.score_calc.calc_trans_score(
                rigid.rigid_trans(init_rigids), out["pred_trans"], t[:, None, None])
            out["rot_score"] = rot_score * bb_mask[..., None]
            out["trans_score"] = trans_score * bb_mask[..., None]
        return out
