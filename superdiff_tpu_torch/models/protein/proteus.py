"""Checkpoint-faithful Proteus SE(3) score network (port of
``superdiff_tpu/models/protein/proteus.py``).

The modules carry the reference's own ``state_dict`` names (517 tensors at
the published config, ``tests/fixtures/proteus_state_dict_schema.json``),
so a reference checkpoint loads by ``load_state_dict``. What it computes at
inference:

* Embedder: t / fixed / aatype-UNK node features, cross-concat and
  relative-position pair features, the zero-init ss / adjacency / hotspot
  conditioning embedders, and the template self-condition (AF2 template
  angle / pair features of the previous step's atoms, the triangle
  multiplicative pair stack, pointwise / column-wise cross attention).
* The IPA trunk shared with ``framediff.py``, with LocalTriangleAttentionNew
  as the edge transition: an RBF-gated triangle bias, triangle
  multiplications and k-NN local attention over both pair axes (the
  neighbours picked by a stable sort, so ties go to the lower index as
  ``lax.top_k`` breaks them).
* The distogram_6d auxiliary heads; atom37 from the predicted frames.

With ``struct2seq_enable`` the embedder also holds the
``struct2seq_cross_embedder`` and, when one is given, the MPNN + ESM
sequence conditioner (``struct2seq.MPNNESM``) as ``struct2seq_embedder``;
its frozen parts stay out of the ``state_dict``, so a Proteus checkpoint
(cross embedder and combiner heads) loads by ``load_state_dict``. A step
runs the branch when its ``struct2seq`` flag is set.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..from_jax import flax_zeros
from . import all_atom37 as aa
from . import residue_constants as rc
from . import rigid
from .framediff import FrameDiffConfig, TorsionAngles, build_trunk, mlp3ln, \
    timestep_embedding, trunk_block
from .pairformer import (
    GatedAttention,
    LightTemplatePairStackBlock,
    PairTransition,
    TemplateAngleEmbedder,
    TemplateColumnWiseAttention,
    TemplatePairEmbedder,
    TemplatePointwiseAttention,
    TriangleMultiplication,
)


@dataclasses.dataclass(frozen=True)
class ProteusConfig:
    """Resolved ``model:`` section of Proteus config/base.yaml."""

    node_embed_size: int = 256
    edge_embed_size: int = 128
    mode: str = "monomer"
    # embed.feature
    t_embed_size: int = 32
    rel_pos: int = 32
    aatype_feature: bool = False  # False = embed UNK one-hot, True = real aatype
    # embed.self_condition
    sc_version: str = "template"
    sc_aatype: str = "mask"  # GLY-mask the self-condition sequence
    struct2seq_enable: bool = False
    struct2seq_c_hidden_pt: int = 32
    struct2seq_heads_pt: int = 4
    struct2seq_c_hidden_cw: int = 64
    struct2seq_heads_cw: int = 4
    # embed.template
    c_t: int = 64
    template_min_bin: float = 3.25
    template_max_bin: float = 50.75
    template_no_bins: int = 39
    template_angle_c_in: int = 57
    tri_mul_hidden: int = 32
    pair_transition_n: int = 2
    cross_pt_c_hidden: int = 16
    cross_pt_heads: int = 4
    cross_cw_c_hidden: int = 64
    cross_cw_heads: int = 4
    # ipa trunk
    c_hidden: int = 256
    c_skip: int = 64
    no_heads: int = 8
    no_qk_points: int = 8
    no_v_points: int = 12
    seq_tfmr_num_heads: int = 4
    seq_tfmr_num_layers: int = 2
    num_blocks: int = 4
    coordinate_scaling: float = 0.1
    # local triangle attention (edge transitions)
    lta_c_rbf: int = 64
    lta_c_gate_s: int = 16
    lta_c_hidden: int = 128
    lta_c_hidden_mul: int = 128
    lta_no_heads: int = 4
    lta_transition_n: int = 2
    lta_k_neighbour: int = 32
    lta_k_linear: int = 0
    inf: float = 1e9
    # aux heads
    dist_bins: int = 37
    theta_bins: int = 37
    omega_bins: int = 37
    phi_bins: int = 19

    def trunk_cfg(self) -> FrameDiffConfig:
        """Config view for the FrameDiff-shared trunk blocks."""
        return FrameDiffConfig(
            node_embed_size=self.node_embed_size,
            edge_embed_size=self.edge_embed_size,
            c_hidden=self.c_hidden, c_skip=self.c_skip, no_heads=self.no_heads,
            no_qk_points=self.no_qk_points, no_v_points=self.no_v_points,
            seq_tfmr_num_heads=self.seq_tfmr_num_heads,
            seq_tfmr_num_layers=self.seq_tfmr_num_layers,
            num_blocks=self.num_blocks,
            coordinate_scaling=self.coordinate_scaling,
        )

    @staticmethod
    def tiny() -> "ProteusConfig":
        return ProteusConfig(
            node_embed_size=32, edge_embed_size=16, t_embed_size=8, rel_pos=4,
            c_t=8, tri_mul_hidden=8, cross_pt_c_hidden=4, cross_cw_c_hidden=8,
            c_hidden=16, c_skip=8, no_heads=2, no_qk_points=2, no_v_points=3,
            seq_tfmr_num_heads=2, seq_tfmr_num_layers=1, num_blocks=2,
            lta_c_rbf=8, lta_c_gate_s=4, lta_c_hidden=8, lta_c_hidden_mul=8,
            lta_no_heads=2, lta_k_neighbour=4,
        )

    @staticmethod
    def from_ckpt_conf(mc: dict) -> "ProteusConfig":
        embed = mc.get("embed", {})
        feat = embed.get("feature", {})
        sc = embed.get("self_condition", {})
        tpl = embed.get("template", {})
        ipa = mc.get("ipa", {})
        lta = ipa.get("local_triangle_attention_new", {})
        aux = mc.get("auxiliary_heads", {}).get("distogram_6d", {})
        s2s = sc.get("struct2seq", {})
        return ProteusConfig(
            node_embed_size=int(mc.get("node_embed_size", 256)),
            edge_embed_size=int(mc.get("edge_embed_size", 128)),
            mode=mc.get("mode", "monomer"),
            t_embed_size=int(feat.get("t", 32)),
            rel_pos=int(feat.get("rel_pos", 32)),
            aatype_feature=bool(feat.get("aatype", False)),
            sc_version=sc.get("version", "template"),
            sc_aatype=sc.get("aatype", "mask"),
            struct2seq_enable=bool(s2s.get("enable", False)),
            c_t=int(tpl.get("c_t", 64)),
            template_min_bin=float(tpl.get("distogram", {}).get("min_bin", 3.25)),
            template_max_bin=float(tpl.get("distogram", {}).get("max_bin", 50.75)),
            template_no_bins=int(tpl.get("distogram", {}).get("no_bins", 39)),
            template_angle_c_in=int(
                tpl.get("template_angle_embedder", {}).get("c_in", 57)
            ),
            tri_mul_hidden=int(
                tpl.get("template_pair_stack", {}).get("c_hidden_tri_mul", 32)
            ),
            pair_transition_n=int(
                tpl.get("template_pair_stack", {}).get("pair_transition_n", 2)
            ),
            cross_pt_c_hidden=int(
                tpl.get("template_cross_embedder", {})
                .get("template_pointwise_attention", {}).get("c_hidden", 16)
            ),
            cross_pt_heads=int(
                tpl.get("template_cross_embedder", {})
                .get("template_pointwise_attention", {}).get("no_heads", 4)
            ),
            cross_cw_c_hidden=int(
                tpl.get("template_cross_embedder", {})
                .get("template_column_wise_attention", {}).get("c_hidden", 64)
            ),
            cross_cw_heads=int(
                tpl.get("template_cross_embedder", {})
                .get("template_column_wise_attention", {}).get("no_heads", 4)
            ),
            c_hidden=int(ipa.get("c_hidden", 256)),
            c_skip=int(ipa.get("c_skip", 64)),
            no_heads=int(ipa.get("no_heads", 8)),
            no_qk_points=int(ipa.get("no_qk_points", 8)),
            no_v_points=int(ipa.get("no_v_points", 12)),
            seq_tfmr_num_heads=int(ipa.get("seq_tfmr_num_heads", 4)),
            seq_tfmr_num_layers=int(ipa.get("seq_tfmr_num_layers", 2)),
            num_blocks=int(ipa.get("num_blocks", 4)),
            coordinate_scaling=float(ipa.get("coordinate_scaling", 0.1)),
            lta_c_rbf=int(lta.get("c_rbf", 64)),
            lta_c_gate_s=int(lta.get("c_gate_s", 16)),
            lta_c_hidden=int(lta.get("c_hidden", 128)),
            lta_c_hidden_mul=int(lta.get("c_hidden_mul", 128)),
            lta_no_heads=int(lta.get("no_heads", 4)),
            lta_transition_n=int(lta.get("transition_n", 2)),
            lta_k_neighbour=int(lta.get("k_neighbour", 32)),
            lta_k_linear=int(lta.get("k_linear", 0)),
            dist_bins=int(aux.get("dist", {}).get("no_bins", 37)),
            theta_bins=int(aux.get("theta", {}).get("no_bins", 37)),
            omega_bins=int(aux.get("omega", {}).get("no_bins", 37)),
            phi_bins=int(aux.get("phi", {}).get("no_bins", 19)),
        )


# ---------------------------------------------------------------------------
# Template features (openfold feats.py)
# ---------------------------------------------------------------------------


def build_template_angle_feat(f: dict) -> torch.Tensor:
    """One-hot(22) ++ torsions(14) ++ alt(14) ++ mask(7)."""
    tors = f["template_torsion_angles_sin_cos"]
    alt = f["template_alt_torsion_angles_sin_cos"]
    return torch.cat([
        F.one_hot(f["template_aatype"].long(), 22).float(),
        tors.reshape(tors.shape[:-2] + (14,)),
        alt.reshape(alt.shape[:-2] + (14,)),
        f["template_torsion_angles_mask"],
    ], dim=-1)


def build_template_pair_feat(f: dict, min_bin: float, max_bin: float, no_bins: int,
                             eps: float = 1e-20, inf: float = 1e8) -> torch.Tensor:
    """Squared-distance distogram, aatype one-hots and the N-CA-C frame
    unit vectors. As in the vendored openfold, ``upper`` is built from
    ``lower[:-1]``, which zeroes every bin but the last: the Proteus
    checkpoints are trained against it."""
    tpb = f["template_pseudo_beta"]
    mask = f["template_pseudo_beta_mask"]
    mask_2d = mask[..., None] * mask[..., None, :]
    d2 = torch.sum((tpb[..., None, :] - tpb[..., None, :, :]) ** 2, dim=-1, keepdim=True)
    lower = torch.linspace(min_bin, max_bin, no_bins, device=tpb.device) ** 2
    upper = torch.cat([lower[:-1], torch.full((1,), inf, device=tpb.device)])
    dgram = ((d2 > lower) * (d2 < upper)).to(d2.dtype)

    aatype_oh = F.one_hot(f["template_aatype"].long(), rc.restype_num + 2).to(d2.dtype)
    n_res = f["template_aatype"].shape[-1]
    lead = aatype_oh.shape[:-2]
    to_concat = [dgram, mask_2d[..., None],
                 aatype_oh[..., None, :, :].expand(lead + (n_res, n_res, -1)),
                 aatype_oh[..., None, :].expand(lead + (n_res, n_res, -1))]
    pos = f["template_all_atom_positions"]
    rot, trans = aa.make_transform_from_reference(
        pos[..., rc.N_IDX, :], pos[..., rc.CA_IDX, :], pos[..., rc.C_IDX, :], eps=eps)
    # invert_apply of frame i on point j: R_i^T (p_j - t_i)
    rigid_vec = (rot.transpose(-1, -2)[..., :, None, :, :]
                 @ (trans[..., None, :, :] - trans[..., :, None, :])[..., None])[..., 0]
    inv_d = torch.rsqrt(eps + torch.sum(rigid_vec**2, dim=-1))
    m = f["template_all_atom_mask"]
    bb_mask = m[..., rc.N_IDX] * m[..., rc.CA_IDX] * m[..., rc.C_IDX]
    bb_mask_2d = bb_mask[..., None] * bb_mask[..., None, :]
    unit = rigid_vec * (inv_d * bb_mask_2d)[..., None]
    to_concat.extend([unit[..., i, None] for i in range(3)])
    to_concat.append(bb_mask_2d[..., None])
    return torch.cat(to_concat, dim=-1) * bb_mask_2d[..., None]


def positional_pair_features(residue_index, chain_index, max_rel: int, mode: str):
    """The parameter-free PositionalEmbedder (monomer: chain-offset residue
    indices, one chain)."""
    if mode == "monomer":
        first = torch.cumsum(torch.cat([
            torch.zeros_like(chain_index[..., :1]),
            (chain_index[..., 1:] != chain_index[..., :-1]).to(chain_index.dtype),
        ], dim=-1), dim=-1)
        n = residue_index.shape[-1]
        pos = torch.arange(n, device=residue_index.device).expand(residue_index.shape) \
            + first * 64
        chain = torch.zeros_like(chain_index)
        asym = chain
    else:
        pos, chain, asym = residue_index, chain_index, chain_index
    chain_same = chain[..., :, None] == chain[..., None, :]
    asym_same = asym[..., :, None] == asym[..., None, :]
    offset = pos[..., :, None] - pos[..., None, :]
    clipped = torch.clamp(offset + max_rel, 0, 2 * max_rel)
    clipped = torch.where(asym_same, clipped, 2 * max_rel + 1)
    rel_pos = F.one_hot(clipped.long(), 2 * max_rel + 2)
    chain_rel = F.one_hot(chain_same.long(), 2)
    return torch.cat([rel_pos, chain_rel], dim=-1).float()


# ---------------------------------------------------------------------------
# Embedders
# ---------------------------------------------------------------------------


class TemplateCrossEmbedder(nn.Module):
    def __init__(self, c_t, c_z, c_s, pt_c_hidden, pt_heads, cw_c_hidden, cw_heads,
                 inf=1e9):
        super().__init__()
        self.template_columnwise_attention = TemplateColumnWiseAttention(
            c_s, cw_c_hidden, cw_heads, inf)
        self.template_pointwise_att = TemplatePointwiseAttention(
            c_t, c_z, pt_c_hidden, pt_heads, inf)

    def forward(self, t_s, t_z, s, z, template_mask):
        return (self.template_columnwise_attention(t_s, s, template_mask),
                self.template_pointwise_att(t_z, z, template_mask))


class TemplateEmbedder(nn.Module):
    """Both the multi-template branch (real template features in the batch)
    and the self-conditioning branch (the previous step's atoms); their
    embedded templates are concatenated along the template axis before the
    cross attention, as the reference's forward does."""

    def __init__(self, cfg: ProteusConfig):
        super().__init__()
        self.cfg = cfg
        self.self_condition_s = nn.Linear(cfg.node_embed_size, cfg.node_embed_size)
        self.self_condition_z = nn.Linear(cfg.edge_embed_size, cfg.c_t)
        self.template_angle_embedder = TemplateAngleEmbedder(cfg.template_angle_c_in,
                                                             cfg.node_embed_size)
        self.template_pair_embedder = TemplatePairEmbedder(88, cfg.c_t)
        self.template_pair_stack = LightTemplatePairStackBlock(
            cfg.c_t, cfg.tri_mul_hidden, cfg.pair_transition_n)
        self.template_cross_embedder = TemplateCrossEmbedder(
            cfg.c_t, cfg.edge_embed_size, cfg.node_embed_size, cfg.cross_pt_c_hidden,
            cfg.cross_pt_heads, cfg.cross_cw_c_hidden, cfg.cross_cw_heads, cfg.inf)

    def _pair_feat(self, f):
        cfg = self.cfg
        return build_template_pair_feat(f, cfg.template_min_bin, cfg.template_max_bin,
                                        cfg.template_no_bins, eps=1e-6, inf=cfg.inf)

    def forward(self, node_embed, edge_embed, pair_mask, self_condition, sc_active,
                template_batch=None):
        """``sc_active`` (0 or 1) gates the self-condition's contribution
        (the reference returns zeros when there is none); the branch runs on
        the zero dummy and is masked, as in JAX. With ``template_batch``, a
        template empty across the whole batch is zeroed and the gate also
        masks the self-condition row out of the cross attention."""
        angles, pairs, masks = [], [], []
        if template_batch is not None:
            t_angle = self.template_angle_embedder(build_template_angle_feat(template_batch))
            t_pair = self.template_pair_embedder(self._pair_feat(template_batch).float())
            keep = (template_batch["template_mask"].sum(dim=0) > 0).to(t_angle.dtype)
            angles.append(t_angle * keep[None, :, None, None])
            pairs.append(t_pair * keep[None, :, None, None, None])
            masks.append(template_batch["template_mask"].float())

        aatype = self_condition["aatype"]
        pos = self_condition["final_atom_positions"]
        mask = self_condition["final_atom_mask"]
        torsions, alt_torsions, torsion_mask = aa.atom37_to_torsion_angles(aatype, pos, mask)
        pseudo_beta, pseudo_beta_mask = aa.pseudo_beta_fn(aatype, pos, mask)
        cf = {
            "template_aatype": aatype[:, None],
            "template_all_atom_positions": pos[:, None],
            "template_all_atom_mask": mask[:, None],
            "template_pseudo_beta": pseudo_beta[:, None],
            "template_pseudo_beta_mask": pseudo_beta_mask[:, None],
            "template_torsion_angles_sin_cos": torsions[:, None],
            "template_alt_torsion_angles_sin_cos": alt_torsions[:, None],
            "template_torsion_angles_mask": torsion_mask[:, None],
        }
        angle = self.template_angle_embedder(build_template_angle_feat(cf))
        pair = self.template_pair_embedder(self._pair_feat(cf))
        if "node_embed" in self_condition and "edge_embed" in self_condition:
            angle = angle + self.self_condition_s(self_condition["node_embed"][:, None])
            pair = pair + self.self_condition_z(self_condition["edge_embed"][:, None])
        sc_mask = torch.ones(aatype.shape[:1] + (1,), device=pos.device)

        if template_batch is None:
            pair = self.template_pair_stack(pair, pair_mask[:, None])
            t_s, t_z = self.template_cross_embedder(angle, pair, node_embed, edge_embed,
                                                    sc_mask)
            return t_s * sc_active, t_z * sc_active

        angles.append(angle * sc_active)
        pairs.append(pair * sc_active)
        masks.append(sc_mask * sc_active)
        pair_all = self.template_pair_stack(torch.cat(pairs, dim=1), pair_mask[:, None])
        return self.template_cross_embedder(torch.cat(angles, dim=1), pair_all, node_embed,
                                            edge_embed, torch.cat(masks, dim=1))


class ProteusEmbedder(nn.Module):
    """``score_network.Embedder``; ``struct2seq`` an optional
    ``struct2seq.MPNNESM`` (used when ``cfg.struct2seq_enable``)."""

    def __init__(self, cfg: ProteusConfig, struct2seq: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        c_node = cfg.t_embed_size + 1 + 21
        c_pair = 2 * c_node + 2 * cfg.rel_pos + 2 + 2
        self.node_embedder = mlp3ln(c_node, cfg.node_embed_size)
        self.edge_embedder = mlp3ln(c_pair, cfg.edge_embed_size)
        self.ss_embedder = flax_zeros(nn.Linear(4, cfg.node_embed_size))
        self.adjacency_embedder = flax_zeros(nn.Linear(3, cfg.edge_embed_size))
        self.hotspot_embedder = flax_zeros(nn.Linear(2, cfg.node_embed_size))
        if cfg.sc_version == "template":
            self.template_embedder = TemplateEmbedder(cfg)
        if cfg.struct2seq_enable:
            if struct2seq is not None:
                self.struct2seq_embedder = struct2seq
            self.struct2seq_cross_embedder = TemplateCrossEmbedder(
                cfg.edge_embed_size, cfg.edge_embed_size, cfg.node_embed_size,
                cfg.struct2seq_c_hidden_pt, cfg.struct2seq_heads_pt,
                cfg.struct2seq_c_hidden_cw, cfg.struct2seq_heads_cw, cfg.inf)

    def forward(self, batch: dict, t, fixed_mask, self_condition: Optional[dict],
                struct2seq=False, struct2seq_draws=None):
        cfg = self.cfg
        seq_idx = batch["residue_index"]
        b, n = seq_idx.shape
        t_emb = timestep_embedding(t, cfg.t_embed_size)[:, None, :].expand(b, n, -1)
        prot_t = torch.cat([t_emb, fixed_mask[..., None]], dim=-1)
        # feature.aatype=False still embeds the UNK one-hot
        aat = (batch["aatype"] if cfg.aatype_feature
               else torch.full_like(batch["aatype"], rc.resname_to_idx["UNK"]))
        prot_t = torch.cat([prot_t, F.one_hot(aat.long(), 21).float()], dim=-1)
        cross = torch.cat([prot_t[:, :, None, :].expand(b, n, n, -1),
                           prot_t[:, None, :, :].expand(b, n, n, -1)], dim=-1)
        pair_in = torch.cat([cross, positional_pair_features(
            seq_idx, batch["chain_index"], cfg.rel_pos, cfg.mode)], dim=-1)

        # the self-condition: a zero dummy (inactive) when there is none
        dev = prot_t.device
        sc_active = 0.0 if self_condition is None else self_condition.get("active", 1.0)
        if self_condition is None:
            self_condition = {
                "final_atom_positions": torch.zeros((b, n, 37, 3), device=dev),
                "final_atom_mask": torch.zeros((b, n, 37), device=dev),
                "node_embed": torch.zeros((b, n, cfg.node_embed_size), device=dev),
                "edge_embed": torch.zeros((b, n, n, cfg.edge_embed_size), device=dev),
            }
        self_condition = dict(self_condition)
        self_condition["aatype"] = (torch.full_like(batch["aatype"], rc.GLY_IDX)
                                    if cfg.sc_aatype == "mask" else batch["aatype"])
        gly_mask = torch.as_tensor(rc.STANDARD_ATOM_MASK[rc.GLY_IDX], dtype=torch.float32,
                                   device=dev)
        self_condition["final_atom_mask"] = self_condition["final_atom_mask"] * gly_mask
        self_condition["final_atom_positions"] = (
            self_condition["final_atom_positions"]
            * self_condition["final_atom_mask"][..., None])

        node = self.node_embedder(prot_t)
        edge = self.edge_embedder(pair_in)
        node = node + self.ss_embedder(batch["ss"])
        node = node + self.hotspot_embedder(batch["hotspot"])
        edge = edge + self.adjacency_embedder(batch["adjacency"])
        if cfg.sc_version == "template":
            seq_mask = batch["res_mask"].float()
            pair_mask = seq_mask[..., :, None] * seq_mask[..., None, :]
            template_batch = None
            if "template_mask" in batch:
                template_batch = {k: v for k, v in batch.items() if k.startswith("template_")}
            t_s, t_z = self.template_embedder(node, edge, pair_mask, self_condition,
                                              sc_active, template_batch=template_batch)
            node = node + t_s
            edge = edge + t_z
        # ``struct2seq``: a bool (the step's gate: False skips the branch) or
        # a 0/1 tensor that runs it and scales its output, as JAX's traced flag
        if cfg.struct2seq_enable and not (isinstance(struct2seq, bool) and not struct2seq):
            if not hasattr(self, "struct2seq_embedder"):
                warnings.warn("struct2seq enabled but no MPNN + ESM conditioner given; "
                              "skipping ESM conditioning", stacklevel=2)
            else:
                esm_s, esm_p = self.struct2seq_embedder(self_condition, struct2seq_draws)
                t_s, t_z = self.struct2seq_cross_embedder(
                    esm_s, esm_p, node, edge, torch.ones((b, 1), device=dev))
                if not isinstance(struct2seq, bool):
                    flag = torch.as_tensor(struct2seq, dtype=torch.float32, device=dev)
                    t_s, t_z = flag * t_s, flag * t_z
                node = node + t_s
                edge = edge + t_z
        return node, edge


# ---------------------------------------------------------------------------
# Local triangle attention (the Proteus edge transition)
# ---------------------------------------------------------------------------


class LocalTriangleAttentionNew(nn.Module):
    """``ipa_pytorch.LocalTriangleAttentionNew``."""

    def __init__(self, cfg: ProteusConfig):
        super().__init__()
        self.cfg = cfg
        c_s, c_z, h = cfg.node_embed_size, cfg.edge_embed_size, cfg.lta_no_heads
        self.proj_left = nn.Linear(c_s, cfg.lta_c_gate_s)
        self.proj_right = nn.Linear(c_s, cfg.lta_c_gate_s)
        self.to_gate = nn.Linear(cfg.lta_c_gate_s**2, c_z)
        self.emb_rbf = nn.Linear(cfg.lta_c_rbf, c_z)
        self.to_bias = nn.Linear(c_z, h, bias=False)
        self.tri_mul_out = TriangleMultiplication(c_z, cfg.lta_c_hidden_mul, outgoing=True)
        self.tri_mul_in = TriangleMultiplication(c_z, cfg.lta_c_hidden_mul, outgoing=False)
        self.mha_start = GatedAttention(c_z, c_z, c_z, cfg.lta_c_hidden, h, gating=True)
        self.mha_end = GatedAttention(c_z, c_z, c_z, cfg.lta_c_hidden, h, gating=True)
        # declared by the reference but never called in its forward
        self.pair_transition = PairTransition(c_z, cfg.lta_transition_n)
        self.layer_norm = nn.LayerNorm(c_z, eps=1e-5)

    def forward(self, node, edge, rigids7, edge_mask):
        cfg = self.cfg
        b, n, _ = node.shape
        coords = rigid.rigid_trans(rigids7)  # angstroms (the trunk unscales first)
        d = torch.linalg.norm(coords[:, :, None, :] - coords[:, None, :, :], dim=-1)
        # RBF embedding of pair distances (D_min = 0, D_sigma = 0.5)
        d_mu = torch.linspace(0.0, (cfg.lta_c_rbf - 1) * 0.5, cfg.lta_c_rbf, device=d.device)
        bias = self.emb_rbf(torch.exp(-(((d[..., None] - d_mu) / 0.5) ** 2)))
        left, right = self.proj_left(node), self.proj_right(node)
        gate = torch.einsum("bli,bmj->blmij", left, right).reshape(b, n, n, -1)
        bias = self.to_bias(bias * torch.sigmoid(self.to_gate(gate)))  # (B, N, N, H)
        k = min(cfg.lta_k_neighbour + cfg.lta_k_linear, n)
        bi = torch.arange(b, device=d.device)[:, None, None]
        ri = torch.arange(n, device=d.device)[None, :, None]
        diag = torch.eye(n, dtype=torch.bool, device=d.device)

        def knn_indices(mask2d):
            # as the reference: distances not scaled, masked pairs get -inf
            # (preferred); the k smallest by a stable sort, ties to the lower
            # index as lax.top_k breaks them
            dist = torch.where(diag, cfg.inf, d) + cfg.inf * (mask2d - 1.0)
            return torch.sort(dist, dim=-1, stable=True).indices[..., :k]  # (B, N, K)

        def local_mha(x, bias_h, mask2d, starting):
            mha = self.mha_start if starting else self.mha_end
            if not starting:
                x = x.transpose(-2, -3)
                bias_h = bias_h.transpose(-2, -3)
                mask2d = mask2d.transpose(-1, -2)
            idx = knn_indices(mask2d)
            xg = self.layer_norm(x[bi, ri, idx])  # (B, N, K, C)
            mg = mask2d[bi, ri, idx]  # (B, N, K)
            mask_bias = (cfg.inf * (mg - 1.0))[:, :, None, None, :]
            # the reference's triangle bias, gathered over a broadcast axis:
            # bias[b, i, idx[b, i, k_key], h], constant over the query axis
            tb = bias_h[bi, ri, idx].transpose(-1, -2)[:, :, :, None, :]  # (B, N, H, 1, K)
            full = torch.zeros_like(x)
            full[bi, ri, idx] = mha(xg, xg, biases=[mask_bias, tb])
            return full if starting else full.transpose(-2, -3)

        z = edge
        z = z + self.tri_mul_out(z, edge_mask)
        z = z + self.tri_mul_in(z, edge_mask)
        z = z + local_mha(z, bias, edge_mask, starting=True)
        return z + local_mha(z, bias, edge_mask, starting=False)


class DistogramHead(nn.Module):
    def __init__(self, c_z: int, no_bins: int, asymmetry: bool = False):
        super().__init__()
        self.asymmetry = asymmetry
        self.linear = flax_zeros(nn.Linear(c_z, no_bins))

    def forward(self, z):
        logits = self.linear(z)
        if not self.asymmetry:
            logits = (logits + logits.transpose(-2, -3)) / 2
        return logits


class AuxiliaryHeads(nn.Module):
    def __init__(self, cfg: ProteusConfig):
        super().__init__()
        c = cfg.edge_embed_size
        self.dist_head = DistogramHead(c, cfg.dist_bins)
        self.omega_head = DistogramHead(c, cfg.omega_bins)
        self.theta_head = DistogramHead(c, cfg.theta_bins, asymmetry=True)
        self.phi_head = DistogramHead(c, cfg.phi_bins, asymmetry=True)

    def forward(self, z):
        return {"dist6d_logits": self.dist_head(z), "omega6d_logits": self.omega_head(z),
                "theta6d_logits": self.theta_head(z), "phi6d_logits": self.phi_head(z)}


class ProteusIpaScore(nn.Module):
    def __init__(self, cfg: ProteusConfig):
        super().__init__()
        self.trunk = build_trunk(cfg.trunk_cfg(), lambda b: LocalTriangleAttentionNew(cfg))
        # in the checkpoints; the inference path takes the input torsions
        self.torsion_pred = TorsionAngles(cfg.node_embed_size, num_torsions=7)


class ProteusScoreNetwork(nn.Module):
    """``score_network.ScoreNetwork``, the inference path: predicted frames
    and atoms, and the node / edge embeddings a caller may carry as the next
    step's self-condition."""

    def __init__(self, cfg: ProteusConfig, struct2seq: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.embedding_layer = ProteusEmbedder(cfg, struct2seq)
        self.score_model = ProteusIpaScore(cfg)
        self.auxiliary_heads = AuxiliaryHeads(cfg)

    def forward(self, feats: dict, self_condition: Optional[dict] = None,
                struct2seq=False, struct2seq_draws=None) -> dict:
        """``struct2seq``: this step's gate of the MPNN + ESM branch (see
        ``ProteusEmbedder.forward``); ``struct2seq_draws`` the MPNN draws, one
        ``struct2seq.mpnn_draws`` dict per sequence (else drawn)."""
        cfg = self.cfg
        node_mask = feats["res_mask"].float()
        fixed_mask = feats["fixed_mask"].float()
        edge_mask = node_mask[..., None] * node_mask[..., None, :]
        diffuse_mask = (1.0 - fixed_mask) * node_mask

        init_node, init_edge = self.embedding_layer(feats, feats["t"], fixed_mask,
                                                    self_condition, struct2seq,
                                                    struct2seq_draws)
        edge = init_edge * edge_mask[..., None]
        node = init_node * node_mask[..., None]
        init_node = node

        init_rigids = feats["rigids_t"].float()
        scale = cfg.coordinate_scaling
        curr = rigid.scale_trans(init_rigids, scale)
        trunk = self.score_model.trunk
        for b in range(cfg.num_blocks):
            node, curr = trunk_block(trunk, b, node, edge, curr, init_node, node_mask,
                                     diffuse_mask)
            if b < cfg.num_blocks - 1:
                edge = trunk[f"edge_transition_{b}"](
                    node, edge, rigid.scale_trans(curr, 1.0 / scale), edge_mask)
                edge = edge * edge_mask[..., None]
        aux_out = self.auxiliary_heads(edge)

        pred_rigids = rigid.scale_trans(curr, 1.0 / scale)
        rot = rigid.rigid_rotmat(pred_rigids)
        trans = rigid.rigid_trans(pred_rigids)
        rot8, trans8 = aa.torsion_angles_to_frames(rot, trans, feats["torsion_angles_sin_cos"],
                                                   feats["aatype"])
        atom14 = aa.frames_to_atom14_pos(rot8, trans8, feats["aatype"])
        atom37 = aa.atom14_to_atom37(atom14, feats["aatype"])
        atom37_exists = feats.get("atom37_atom_exists")
        if atom37_exists is None:
            atom37_exists = aa.make_atom14_masks(feats["aatype"])["atom37_atom_exists"]
        return {
            "rigids": pred_rigids,
            "pred_trans": trans,
            "pred_rotmats": rot,
            "auxiliary": aux_out,
            "final_atom_positions": atom37,
            "final_atom_mask": atom37_exists,
            "node_embed": node,
            "edge_embed": edge,
        }
