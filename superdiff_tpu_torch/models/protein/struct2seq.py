"""MPNN -> ESM sequence conditioner of Proteus (struct2seq), port of
``superdiff_tpu/models/protein/struct2seq.py``.

A CA-only ProteinMPNN samples ``seq_nums`` sequences for the self-condition
structure, ESM2 embeds each, and learned heads combine ESM2's per-layer
representations and attention maps into a template stack ``(esm_s, esm_p)``
that Proteus's ``struct2seq_cross_embedder`` reads.

The modules carry the reference's own ``state_dict`` names, so a ProteinMPNN
CA pickle (``v_48_020.pt``: ``{'num_edges', 'model_state_dict'}``) loads into
:class:`ProteinMPNNCA` and a transformers ``EsmModel`` state_dict into
:class:`ESM2` by ``load_state_dict`` (``convert.load_mpnn_checkpoint`` /
``load_esm2_snapshot``). :class:`MPNNESM`, as the reference's ``MPNN_ESM``,
leaves the frozen MPNN and ESM2 out of its ``state_dict``: a Proteus
checkpoint carries only the four combiner heads.

Sampling is a Python loop over decode positions (JAX: one ``lax.scan``).
Its draws are the decode-order normals (B, N) and, per step, the Gumbel
noise (B, 21) whose argmax with the logits is the categorical draw (as
``jax.random.categorical`` samples): handed in as ``draws`` (the tests give
JAX's), else drawn from a ``torch.Generator``. Single chain, no padding, as
in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from . import residue_constants as rc

# ProteinMPNN's 21-letter alphabet
MPNN_ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"
# the ESM2 vocabulary (fair-esm's standard alphabet; transformers' ESM
# checkpoints use the same order)
ESM_TOKENS = (["<cls>", "<pad>", "<eos>", "<unk>"] + list("LAGVSERTIDPKQNFYMHWCXBUZO")
              + [".", "-", "<null_1>", "<mask>"])
ESM_CLS, ESM_PAD, ESM_EOS = 0, 1, 2
ESM_MASK = len(ESM_TOKENS) - 1
# AF2 aatype -> MPNN index; MPNN index + 1 (0 = padding) -> ESM token
AF_TO_MPNN = np.array([MPNN_ALPHABET.index(a) for a in rc.restypes_with_x], np.int64)
MPNN_TO_ESM = np.array([ESM_PAD] + [ESM_TOKENS.index(a) for a in MPNN_ALPHABET], np.int64)


# ---------------------------------------------------------------------------
# CA-only ProteinMPNN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPNNConfig:
    """ProteinMPNN hyperparameters (v_48_020: 128 wide, 3 + 3 layers, k 48)."""

    node_features: int = 128
    edge_features: int = 128
    hidden_dim: int = 128
    num_letters: int = 21
    vocab: int = 21
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    k_neighbors: int = 48
    num_rbf: int = 16
    num_positional_embeddings: int = 16
    max_relative_feature: int = 32
    scale: float = 30.0  # message-sum normaliser

    @staticmethod
    def tiny() -> "MPNNConfig":
        return MPNNConfig(node_features=16, edge_features=16, hidden_dim=16,
                          num_encoder_layers=2, num_decoder_layers=2, k_neighbors=6,
                          num_rbf=4, num_positional_embeddings=4)


def gather_nodes(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] at [B, N, K] -> [B, N, K, C]."""
    bi = torch.arange(nodes.shape[0], device=nodes.device)[:, None, None]
    return nodes[bi, idx]


def cat_neighbors_nodes(h_nodes, h_neighbors, e_idx):
    return torch.cat([h_neighbors, gather_nodes(h_nodes, e_idx)], -1)


def _normalize(x, dim: int = -1, eps: float = 1e-12):
    """``F.normalize``: zero vectors stay zero."""
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True), min=eps)


def _quaternions(r):
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (x, y, z, w)."""
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    rxx, ryy, rzz = diag.unbind(-1)
    magnitudes = 0.5 * torch.sqrt(torch.abs(1.0 + torch.stack(
        [rxx - ryy - rzz, -rxx + ryy - rzz, -rxx - ryy + rzz], -1)))
    signs = torch.sign(torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                                    r[..., 1, 0] - r[..., 0, 1]], -1))
    w = torch.sqrt(F.relu(1.0 + diag.sum(-1, keepdim=True))) / 2.0
    return _normalize(torch.cat([signs * magnitudes, w], -1))


class PositionalEncodings(nn.Module):
    def __init__(self, num_embeddings: int, max_relative_feature: int = 32):
        super().__init__()
        self.max_relative_feature = max_relative_feature
        self.linear = nn.Linear(2 * max_relative_feature + 2, num_embeddings)

    def forward(self, offset, mask):
        mr = self.max_relative_feature
        d = torch.clamp(offset + mr, 0, 2 * mr) * mask + (1 - mask) * (2 * mr + 1)
        return self.linear(F.one_hot(d.long(), 2 * mr + 2).float())


class CAProteinFeatures(nn.Module):
    """CA k-NN graph: 9 RBF distance maps over the (previous, own, next) CA
    triplet, local-frame directions and relative-orientation quaternions,
    relative-position encodings."""

    def __init__(self, cfg: MPNNConfig):
        super().__init__()
        self.cfg = cfg
        edge_in = cfg.num_positional_embeddings + cfg.num_rbf * 9 + 7
        self.embeddings = PositionalEncodings(cfg.num_positional_embeddings,
                                              cfg.max_relative_feature)
        # declared by the reference, never used in its forward
        self.node_embedding = nn.Linear(3, cfg.node_features, bias=False)
        self.edge_embedding = nn.Linear(edge_in, cfg.edge_features, bias=False)
        self.norm_nodes = nn.LayerNorm(cfg.node_features)
        self.norm_edges = nn.LayerNorm(cfg.edge_features)

    def forward(self, ca, mask, residue_idx, chain_labels):
        cfg = self.cfg
        b, n, _ = ca.shape
        k = min(cfg.k_neighbors, n)
        mask_2d = mask[:, :, None] * mask[:, None, :]
        d_full = mask_2d * torch.sqrt(((ca[:, :, None] - ca[:, None, :]) ** 2).sum(-1) + 1e-6)
        d_max = d_full.max(-1, keepdim=True).values
        d_adjust = d_full + (1.0 - mask_2d) * d_max
        # the k nearest, ties to the lower index (as lax.top_k)
        d_neighbors, e_idx = torch.sort(d_adjust, dim=-1, stable=True)
        d_neighbors, e_idx = d_neighbors[..., :k], e_idx[..., :k]

        ca0 = F.pad(ca[:, :-1], (0, 0, 1, 0))
        ca2 = F.pad(ca[:, 1:], (0, 0, 0, 1))
        d_mu = torch.linspace(2.0, 22.0, cfg.num_rbf, device=ca.device)
        d_sigma = (22.0 - 2.0) / cfg.num_rbf

        def rbf(d):
            return torch.exp(-(((d[..., None] - d_mu) / d_sigma) ** 2))

        def get_rbf(a, bb):
            dab = torch.sqrt(((a[:, :, None] - bb[:, None, :]) ** 2).sum(-1) + 1e-6)
            return rbf(torch.gather(dab, 2, e_idx))

        rbf_all = torch.cat([rbf(d_neighbors), get_rbf(ca0, ca0), get_rbf(ca2, ca2),
                             get_rbf(ca0, ca), get_rbf(ca0, ca2), get_rbf(ca, ca0),
                             get_rbf(ca, ca2), get_rbf(ca2, ca0), get_rbf(ca2, ca)], -1)

        dx = ca[:, 1:] - ca[:, :-1]
        dx_norm = torch.linalg.norm(dx, dim=-1)
        dx = dx * ((dx_norm > 3.6) & (dx_norm < 4.0))[..., None]
        u = _normalize(dx)
        u_2, u_1 = u[:, :-2], u[:, 1:-1]
        n_2 = _normalize(torch.cross(u_2, u_1, dim=-1))
        o_1 = _normalize(u_2 - u_1)
        o_mat = torch.stack([o_1, n_2, torch.cross(o_1, n_2, dim=-1)], 2)  # (B, N-3, 3, 3)
        o_flat = F.pad(o_mat.reshape(b, n - 3, 9), (0, 0, 1, 2))
        o_neighbors = gather_nodes(o_flat, e_idx).reshape(b, n, k, 3, 3)
        x_neighbors = gather_nodes(ca, e_idx)
        o_mat = o_flat.reshape(b, n, 3, 3)
        du = _normalize(torch.einsum("bnij,bnkj->bnki", o_mat, x_neighbors - ca[:, :, None]))
        r_rel = torch.einsum("bnji,bnkjl->bnkil", o_mat, o_neighbors)
        o_features = torch.cat([du, _quaternions(r_rel)], -1)

        offset = torch.gather(residue_idx[:, :, None] - residue_idx[:, None, :], 2, e_idx)
        d_chains = (chain_labels[:, :, None] == chain_labels[:, None, :]).long()
        e_positional = self.embeddings(offset, torch.gather(d_chains, 2, e_idx))
        e = torch.cat([e_positional, rbf_all, o_features], -1)
        return self.norm_edges(self.edge_embedding(e)), e_idx


class PositionWiseFeedForward(nn.Module):
    def __init__(self, num_hidden: int, num_ff: int):
        super().__init__()
        self.W_in = nn.Linear(num_hidden, num_ff)
        self.W_out = nn.Linear(num_ff, num_hidden)

    def forward(self, x):
        return self.W_out(F.gelu(self.W_in(x)))


def _mlp3(w1, w2, w3, x):
    return w3(F.gelu(w2(F.gelu(w1(x)))))


class EncLayer(nn.Module):
    """Message passing over nodes, then over edges (inference: no dropout)."""

    def __init__(self, num_hidden: int, scale: float = 30.0):
        super().__init__()
        h = num_hidden
        self.scale = scale
        self.W1, self.W2, self.W3 = nn.Linear(3 * h, h), nn.Linear(h, h), nn.Linear(h, h)
        self.W11, self.W12, self.W13 = nn.Linear(3 * h, h), nn.Linear(h, h), nn.Linear(h, h)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(h), nn.LayerNorm(h), nn.LayerNorm(h)
        self.dense = PositionWiseFeedForward(h, 4 * h)

    def forward(self, h_v, h_e, e_idx, mask_v, mask_attend):
        h_ev = cat_neighbors_nodes(h_v, h_e, e_idx)
        h_ev = torch.cat([h_v[:, :, None].expand(-1, -1, h_ev.shape[2], -1), h_ev], -1)
        m = mask_attend[..., None] * _mlp3(self.W1, self.W2, self.W3, h_ev)
        h_v = self.norm1(h_v + m.sum(-2) / self.scale)
        h_v = mask_v[..., None] * self.norm2(h_v + self.dense(h_v))
        h_ev = cat_neighbors_nodes(h_v, h_e, e_idx)
        h_ev = torch.cat([h_v[:, :, None].expand(-1, -1, h_ev.shape[2], -1), h_ev], -1)
        return h_v, self.norm3(h_e + _mlp3(self.W11, self.W12, self.W13, h_ev))


class DecLayer(nn.Module):
    def __init__(self, num_hidden: int, scale: float = 30.0):
        super().__init__()
        h = num_hidden
        self.scale = scale
        self.W1, self.W2, self.W3 = nn.Linear(4 * h, h), nn.Linear(h, h), nn.Linear(h, h)
        self.norm1, self.norm2 = nn.LayerNorm(h), nn.LayerNorm(h)
        self.dense = PositionWiseFeedForward(h, 4 * h)

    def forward(self, h_v, h_e, mask_v=None):
        h_ev = torch.cat([h_v[:, :, None].expand(-1, -1, h_e.shape[2], -1), h_e], -1)
        h_v = self.norm1(h_v + _mlp3(self.W1, self.W2, self.W3, h_ev).sum(-2) / self.scale)
        h_v = self.norm2(h_v + self.dense(h_v))
        return h_v if mask_v is None else mask_v[..., None] * h_v


def decode_masks(decoding_order, e_idx, mask):
    """(backward, forward) attention masks of a decode order: neighbour j is
    backward for i iff j decodes strictly before i."""
    rank = torch.argsort(decoding_order, dim=-1, stable=True)
    omb = (rank[:, :, None] > rank[:, None, :]).float()
    mask_attend = torch.gather(omb, 2, e_idx)[..., None]
    mask_1d = mask[:, :, None, None]
    return mask_1d * mask_attend, mask_1d * (1.0 - mask_attend)


def mpnn_draws(b: int, n: int, generator: Optional[torch.Generator] = None,
               device=None, letters: int = 21) -> dict:
    """One sample's draws: the decode-order normals (B, N) and each step's
    Gumbel noise (N, B, letters)."""
    randn = torch.randn((b, n), generator=generator, device=device)
    u = torch.rand((n, b, letters), generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return {"randn": randn, "gumbel": -torch.log(-torch.log(u.clamp(min=tiny)))}


class ProteinMPNNCA(nn.Module):
    """CA-only ProteinMPNN: the teacher-forced log-probs (``forward``) and
    autoregressive sampling (``sample``)."""

    def __init__(self, cfg: MPNNConfig):
        super().__init__()
        self.cfg = cfg
        self.features = CAProteinFeatures(cfg)
        # declared by the reference, never used (h_V starts from zeros)
        self.W_v = nn.Linear(cfg.node_features, cfg.hidden_dim)
        self.W_e = nn.Linear(cfg.edge_features, cfg.hidden_dim)
        self.W_s = nn.Embedding(cfg.vocab, cfg.hidden_dim)
        self.encoder_layers = nn.ModuleList(
            EncLayer(cfg.hidden_dim, cfg.scale) for _ in range(cfg.num_encoder_layers))
        self.decoder_layers = nn.ModuleList(
            DecLayer(cfg.hidden_dim, cfg.scale) for _ in range(cfg.num_decoder_layers))
        self.W_out = nn.Linear(cfg.hidden_dim, cfg.num_letters)

    def encode(self, ca, mask, residue_idx, chain_labels):
        e, e_idx = self.features(ca, mask, residue_idx, chain_labels)
        h_v = torch.zeros(e.shape[:2] + e.shape[-1:], dtype=e.dtype, device=e.device)
        h_e = self.W_e(e)
        mask_attend = mask[:, :, None] * gather_nodes(mask[..., None], e_idx)[..., 0]
        for layer in self.encoder_layers:
            h_v, h_e = layer(h_v, h_e, e_idx, mask, mask_attend)
        return h_v, h_e, e_idx

    def forward(self, ca, s, mask, chain_m, residue_idx, chain_labels, decoding_order):
        """Teacher-forced log-probs (B, N, 21)."""
        h_v, h_e, e_idx = self.encode(ca, mask, residue_idx, chain_labels)
        h_es = cat_neighbors_nodes(self.W_s(s), h_e, e_idx)
        h_ex_encoder = cat_neighbors_nodes(torch.zeros_like(h_v), h_e, e_idx)
        h_exv_encoder = cat_neighbors_nodes(h_v, h_ex_encoder, e_idx)
        mask_bw, mask_fw = decode_masks(decoding_order, e_idx, mask)
        h_exv_encoder_fw = mask_fw * h_exv_encoder
        for layer in self.decoder_layers:
            h_esv = mask_bw * cat_neighbors_nodes(h_v, h_es, e_idx) + h_exv_encoder_fw
            h_v = layer(h_v, h_esv, mask)
        return F.log_softmax(self.W_out(h_v), -1)

    @torch.no_grad()
    def sample(self, ca, mask, residue_idx, chain_labels, s_true, chain_mask, *,
               temperature: float = 0.1, omit_aas: str = "CX", draws: Optional[dict] = None,
               generator: Optional[torch.Generator] = None):
        """Sampled MPNN-alphabet indices (B, N): positions in ``chain_mask``
        are drawn, the others copy ``s_true``. ``draws`` as
        :func:`mpnn_draws` gives, else drawn from ``generator``."""
        b, n = s_true.shape
        dev = ca.device
        if draws is None:
            draws = mpnn_draws(b, n, generator, dev, self.cfg.num_letters)
        h_v, h_e, e_idx = self.encode(ca, mask, residue_idx, chain_labels)
        chain_mask = chain_mask * mask
        decoding_order = torch.argsort((chain_mask + 1e-4) * torch.abs(draws["randn"]), dim=-1,
                                       stable=True)
        mask_bw, mask_fw = decode_masks(decoding_order, e_idx, mask)
        h_ex_encoder = cat_neighbors_nodes(torch.zeros_like(h_v), h_e, e_idx)
        h_exv_encoder_fw = mask_fw * cat_neighbors_nodes(h_v, h_ex_encoder, e_idx)
        omit = torch.tensor([aa in omit_aas for aa in MPNN_ALPHABET], dtype=torch.float32,
                            device=dev)
        n_dec = len(self.decoder_layers)
        # the nodes of every decoder depth: 0 the encoder's, the rest filled
        # position by position in decode order
        h_v_stack = [h_v] + [torch.zeros_like(h_v) for _ in range(n_dec)]
        h_s = torch.zeros_like(h_v)
        s_out = torch.zeros((b, n), dtype=torch.long, device=dev)
        bi = torch.arange(b, device=dev)
        for i in range(n):
            t = decoding_order[:, i]
            e_idx_t = e_idx[bi, t][:, None]
            h_es_t = cat_neighbors_nodes(h_s, h_e[bi, t][:, None], e_idx_t)
            h_exv_t = h_exv_encoder_fw[bi, t][:, None]
            mask_bw_t = mask_bw[bi, t][:, None]
            mask_t = mask[bi, t]
            for l, layer in enumerate(self.decoder_layers):
                h_esv_t = (mask_bw_t * cat_neighbors_nodes(h_v_stack[l], h_es_t, e_idx_t)
                           + h_exv_t)
                new_h = layer(h_v_stack[l][bi, t][:, None], h_esv_t, mask_t[:, None])
                h_v_stack[l + 1][bi, t] = new_h[:, 0]
            logits = self.W_out(h_v_stack[n_dec][bi, t]) / temperature - 1e8 * omit
            s_t = torch.argmax(draws["gumbel"][i] + logits, dim=-1)
            cm_t = chain_mask[bi, t]
            s_t = (s_t * cm_t + s_true[bi, t] * (1.0 - cm_t)).long()
            h_s[bi, t] = self.W_s(s_t)
            s_out[bi, t] = s_t
        return s_out


# ---------------------------------------------------------------------------
# ESM2 (transformers EsmModel names)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    """ESM2 (defaults: esm2_t33_650M_UR50D)."""

    vocab_size: int = 33
    embed_dim: int = 1280
    num_layers: int = 33
    attention_heads: int = 20
    intermediate_dim: int = 5120
    token_dropout: bool = True
    # fair-esm's LayerNorm eps (transformers snapshots pin it in config.json)
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "ESM2Config":
        return ESM2Config(embed_dim=32, num_layers=2, attention_heads=4, intermediate_dim=64)


def _rotary(x):
    """GPT-NeoX rotary embedding over the whole head dim, the frequency table
    duplicated (cat(freqs, freqs)) as fair-esm builds it."""
    t, d = x.shape[-2:]
    inv_freq = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None, :]
    ang = torch.cat([ang, ang], -1)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * torch.cos(ang) + torch.cat([-x2, x1], -1) * torch.sin(ang)


class _Linear(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.dense = nn.Linear(c_in, c_out)


class _EsmSelfAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)


class _EsmAttention(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        c = cfg.embed_dim
        self.self = _EsmSelfAttention(c)
        self.output = _Linear(c, c)
        self.LayerNorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)


class ESM2Layer(nn.Module):
    """Pre-LN transformer block with rotary attention; returns the block's
    output and its attention map."""

    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.cfg = cfg
        self.attention = _EsmAttention(cfg)
        self.intermediate = _Linear(cfg.embed_dim, cfg.intermediate_dim)
        self.output = _Linear(cfg.intermediate_dim, cfg.embed_dim)
        self.LayerNorm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)

    def forward(self, x):
        cfg = self.cfg
        b, t, c = x.shape
        h, d = cfg.attention_heads, c // cfg.attention_heads
        att = self.attention
        y = att.LayerNorm(x)

        def split(z):
            return z.reshape(b, t, h, d).transpose(1, 2)

        q = _rotary(split(att.self.query(y)) * d**-0.5)
        k = _rotary(split(att.self.key(y)))
        v = split(att.self.value(y))
        attn = torch.softmax((q @ k.transpose(-1, -2)).float(), -1).to(x.dtype)
        ctx = (attn @ v).transpose(1, 2).reshape(b, t, c)
        x = x + att.output.dense(ctx)
        y = F.gelu(self.intermediate.dense(self.LayerNorm(x)))
        return x + self.output.dense(y), attn


class _EsmEmbeddings(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.embed_dim)


class _EsmEncoder(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.layer = nn.ModuleList(ESM2Layer(cfg) for _ in range(cfg.num_layers))
        self.emb_layer_norm_after = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)


class ESM2(nn.Module):
    """Token-level ESM2: every layer's representations (B, T, L + 1, C), the
    last after the final LayerNorm as fair-esm returns it, and every layer's
    attention maps (B, L, H, T, T)."""

    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _EsmEmbeddings(cfg)
        self.encoder = _EsmEncoder(cfg)

    def forward(self, tokens):
        x = self.embeddings.word_embeddings(tokens)
        if self.cfg.token_dropout:
            # inference-time rescale (1 - 0.15 * 0.8) / (1 - observed mask ratio)
            is_mask = (tokens == ESM_MASK)[..., None]
            x = torch.where(is_mask, torch.zeros_like(x), x)
            lengths = (tokens != ESM_PAD).sum(-1)
            ratio = (tokens == ESM_MASK).sum(-1) / torch.clamp(lengths, min=1)
            x = x * ((1.0 - 0.15 * 0.8) / (1.0 - ratio))[:, None, None]
        reps, attns = [x], []
        for layer in self.encoder.layer:
            x, attn = layer(x)
            reps.append(x)
            attns.append(attn)
        reps[-1] = self.encoder.emb_layer_norm_after(x)
        return {"representations": torch.stack(reps, 2), "attentions": torch.stack(attns, 1)}


# ---------------------------------------------------------------------------
# MPNN_ESM combiner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPNNESMConfig:
    c_s: int = 256
    c_z: int = 128
    temperature: float = 0.1
    seq_nums: int = 4
    mpnn: MPNNConfig = MPNNConfig()
    esm: ESM2Config = ESM2Config()

    @staticmethod
    def tiny(c_s: int = 32, c_z: int = 16) -> "MPNNESMConfig":
        return MPNNESMConfig(c_s=c_s, c_z=c_z, seq_nums=2, mpnn=MPNNConfig.tiny(),
                             esm=ESM2Config.tiny())


_FROZEN = ("mpnn_model.", "esm.")


def _drop_frozen_missing(module, incompatible_keys):
    """A checkpoint of the combiner heads alone loads strictly."""
    keep = [k for k in incompatible_keys.missing_keys
            if not any(f".{p}" in f".{k}" for p in _FROZEN)]
    incompatible_keys.missing_keys[:] = keep


class MPNNESM(nn.Module):
    """Sample ``seq_nums`` sequences for the self-condition structure with
    ProteinMPNN, embed each with ESM2, combine the layers' representations
    by a learned softmax and project: ``esm_s`` (B, S, N, c_s) and ``esm_p``
    (B, S, N, N, c_z), template stacks for the struct2seq cross embedder.

    The frozen ``mpnn_model`` and ``esm`` are left out of ``state_dict`` and
    may be missing from a loaded one (the reference's override). Without
    ``draws``, each call draws from a generator seeded with ``seed`` on the
    structure's device: every call sees the same stream, as JAX's fixed
    key does."""

    def __init__(self, cfg: MPNNESMConfig, seed: int = 0):
        super().__init__()
        self.cfg, self.seed = cfg, seed
        nl = cfg.esm.num_layers
        self.mpnn_model = ProteinMPNNCA(cfg.mpnn)
        self.esm = ESM2(cfg.esm)
        self.esm_s_combine = nn.Parameter(torch.zeros(nl + 1))
        # declared but unused in the reference forward; kept for its checkpoints
        self.esm_p_combine = nn.Parameter(torch.zeros(nl))
        c = cfg.esm.embed_dim
        self.esm_s_mlp = nn.Sequential(nn.LayerNorm(c), nn.Linear(c, cfg.c_s), nn.ReLU(),
                                       nn.Linear(cfg.c_s, cfg.c_s))
        self.esm_p_mlp = nn.Linear(nl * cfg.esm.attention_heads, cfg.c_z)
        self.register_load_state_dict_post_hook(_drop_frozen_missing)

    def state_dict(self, *args, **kwargs):
        sd = super().state_dict(*args, **kwargs)
        prefix = kwargs.get("prefix", args[1] if len(args) > 1 else "")
        for key in [k for k in sd if k.startswith(tuple(prefix + p for p in _FROZEN))]:
            del sd[key]
        return sd

    def forward(self, self_condition: dict, draws: Optional[Sequence[dict]] = None):
        """``draws``: one :func:`mpnn_draws` dict per sequence, else drawn."""
        cfg = self.cfg
        ca = self_condition["final_atom_positions"][:, :, rc.CA_IDX, :]
        b, n = ca.shape[:2]
        dev = ca.device
        aatype = self_condition.get("aatype")
        if aatype is None:  # the reference's default sequence: all ALA
            aatype = torch.zeros((b, n), dtype=torch.long, device=dev)
        mask = torch.ones((b, n), device=dev)
        residue_idx = torch.arange(n, device=dev)[None].expand(b, n)
        chain_labels = torch.zeros((b, n), dtype=torch.long, device=dev)
        s_true = torch.as_tensor(AF_TO_MPNN, device=dev)[aatype.long()]
        mpnn_to_esm = torch.as_tensor(MPNN_TO_ESM, device=dev)
        gen = None
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
        bi = torch.arange(b, device=dev)
        esm_s_all, esm_p_all = [], []
        for i in range(cfg.seq_nums):
            s = self.mpnn_model.sample(ca, mask, residue_idx, chain_labels, s_true, mask,
                                       temperature=cfg.temperature,
                                       draws=None if draws is None else draws[i],
                                       generator=gen)
            esmaa = mpnn_to_esm[(s + 1) * mask.long()]
            tokens = torch.cat([torch.full((b, 1), ESM_CLS, device=dev), esmaa,
                                torch.full((b, 1), ESM_PAD, device=dev)], 1).long()
            tokens[bi, (tokens != ESM_PAD).sum(1)] = ESM_EOS
            out = self.esm(tokens)
            reps = out["representations"][:, 1:-1]  # (B, N, L + 1, C)
            attn = out["attentions"][..., 1:-1, 1:-1]  # (B, L, H, N, N)
            esm_p = attn.reshape(b, -1, n, n).permute(0, 2, 3, 1)
            esm_s_all.append(reps.float())
            esm_p_all.append(esm_p.float())
        esm_s = torch.stack(esm_s_all, 1)  # (B, S, N, L + 1, C)
        esm_p = torch.stack(esm_p_all, 1)  # (B, S, N, N, L * H)
        w = torch.softmax(self.esm_s_combine, 0)
        esm_s = self.esm_s_mlp(torch.einsum("l,bsnlc->bsnc", w, esm_s))
        return esm_s, self.esm_p_mlp(esm_p)


def init_mpnn_esm(cfg: MPNNESMConfig, seed: int = 0, device=None) -> MPNNESM:
    """An ``MPNNESM`` with the Flax initialisers' distributions, drawn from
    ``seed`` on ``device`` (the card unless given)."""
    from ..from_jax import init_like_flax_

    device = torch.device("cuda" if device is None else device)
    with torch.device(device):
        model = MPNNESM(cfg, seed=seed)
    init_like_flax_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def load_mpnn_esm(proteus_sd: Optional[dict] = None, *, c_s: int = 256, c_z: int = 128,
                  mpnn_ckpt: Optional[str] = None, esm_dir: Optional[str] = None,
                  temperature: float = 0.1, seq_nums: int = 4, seed: int = 0,
                  device=None) -> MPNNESM:
    """An ``MPNNESM`` from its three sources: the combiner heads from a
    Proteus state_dict (``embedding_layer.struct2seq_embedder.*``), the
    frozen ProteinMPNN from ``mpnn_ckpt`` (``v_48_020.pt``) and the frozen
    ESM2 from a local transformers snapshot ``esm_dir``. A part without its
    source keeps its drawn weights, with a warning."""
    import warnings

    from . import convert

    mpnn_cfg, mpnn_sd = MPNNConfig(), None
    if mpnn_ckpt is not None:
        mpnn_sd, k = convert.load_mpnn_checkpoint(mpnn_ckpt)
        mpnn_cfg = dataclasses.replace(mpnn_cfg, k_neighbors=k)
    esm_sd, esm_cfg = (None, ESM2Config()) if esm_dir is None else \
        convert.load_esm2_snapshot(esm_dir)
    cfg = MPNNESMConfig(c_s=c_s, c_z=c_z, temperature=temperature, seq_nums=seq_nums,
                        mpnn=mpnn_cfg, esm=esm_cfg)
    model = init_mpnn_esm(cfg, seed, device)
    heads = convert.extract_struct2seq_heads(proteus_sd or {})
    if heads:
        model.load_state_dict(heads, strict=True)
    else:
        warnings.warn("no struct2seq combiner heads in the Proteus checkpoint; they stay "
                      "drawn", stacklevel=2)
    if mpnn_sd is None:
        warnings.warn("no ProteinMPNN weights given; the MPNN stays drawn", stacklevel=2)
    else:
        model.mpnn_model.load_state_dict(mpnn_sd, strict=True)
    if esm_sd is None:
        warnings.warn("no ESM2 weights given; ESM2 stays drawn", stacklevel=2)
    else:
        convert.load_esm2_state_dict(model.esm, esm_sd)
    return model


def make_struct2seq_fn(model: MPNNESM, draws: Optional[Sequence[dict]] = None):
    """The ``(esm_s, esm_p)`` of a self-condition dict, as Proteus calls it
    (``draws`` fixed for every call, else the model's seeded stream)."""
    return lambda self_condition: model(self_condition, draws)
