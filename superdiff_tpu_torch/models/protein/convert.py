"""Reference protein checkpoints and the Flax parameter mappings (port of
the FrameDiff / Proteus halves of ``superdiff_tpu/models/protein/convert.py``).

The reference distributes FrameDiff / Proteus weights as torch pickles of
the form ``{'conf': OmegaConf, 'model': state_dict, ...}``, DDP checkpoints
with a ``module.`` prefix. :func:`load_torch_checkpoint` reads them without
omegaconf installed (the ``omegaconf.*`` objects are rehydrated through stub
classes and walked into plain dicts, enough for the checkpoint-embedded
model config). The port's networks carry the reference's parameter names,
so the state_dict loads by ``load_state_dict``.

The struct2seq conditioner's frozen parts come as their own files: a
ProteinMPNN CA pickle (:func:`load_mpnn_checkpoint`) and a local
transformers ``EsmModel`` snapshot (:func:`load_esm2_snapshot`); the
combiner heads ride in the Proteus checkpoint
(:func:`extract_struct2seq_heads`).

The mappings (reference key, Flax path, transform) serve one purpose here:
carrying the JAX package's Flax trees of ``FrameDiffScoreNetwork``,
``ProteusScoreNetwork`` and ``MPNNESM`` into the port
(``models/from_jax.py``). The keys the reference forward never uses
(``*_unused_keys``) have no Flax counterpart.
"""

from __future__ import annotations

import io
import pickle
import warnings
from typing import Dict, Optional, Tuple

import torch

from .framediff import FrameDiffConfig


# ---------------------------------------------------------------------------
# Torch-pickle loading without omegaconf installed
# ---------------------------------------------------------------------------


class _ConfStub:
    """Accepts any pickled omegaconf object state; exposes it as attrs."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (dict-state, slots-state)
            state = {k: v for part in state if isinstance(part, dict)
                     for k, v in part.items()}
        self.__dict__.update(state if isinstance(state, dict) else {})


def _stub_find_class(module: str, name: str, default):
    if module.startswith("omegaconf"):
        return type(name, (_ConfStub,), {})
    return default(module, name)


def conf_to_dict(obj):
    """Walk a stub-rehydrated OmegaConf tree into plain python values."""
    if isinstance(obj, _ConfStub):
        d = obj.__dict__
        if "_content" in d:
            return conf_to_dict(d["_content"])
        if "_val" in d:  # ValueNode
            return conf_to_dict(d["_val"])
        return {k: conf_to_dict(v) for k, v in d.items() if not k.startswith("_")}
    if isinstance(obj, dict):
        return {k: conf_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [conf_to_dict(v) for v in obj]
    return obj


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """Load a reference protein checkpoint pickle: (state_dict as float32
    CPU tensors with a leading ``module.`` stripped, conf dict or None)."""

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            return _stub_find_class(module, name, super().find_class)

    class _PickleModule:
        Unpickler = _Unpickler
        load = staticmethod(lambda f, **kw: _Unpickler(f, **kw).load())
        loads = staticmethod(lambda b, **kw: _Unpickler(io.BytesIO(b), **kw).load())

    payload = torch.load(path, map_location="cpu", pickle_module=_PickleModule,
                         weights_only=False)
    if isinstance(payload, dict) and "model" in payload:
        raw_sd = payload["model"]
        conf = None
        try:
            conf = conf_to_dict(payload.get("conf"))
        except Exception as e:  # the conf is best-effort; the weights are the payload
            warnings.warn(f"could not decode checkpoint conf: {e}", stacklevel=2)
    else:
        raw_sd, conf = payload, None
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          torch.as_tensor(v).detach().float() for k, v in raw_sd.items()}
    return sd, conf


# ---------------------------------------------------------------------------
# FrameDiff mapping
# ---------------------------------------------------------------------------

_T = "T"  # transpose linear weight (out,in) -> kernel (in,out)
_ID = None  # copy verbatim


def _linear(torch_mod: str, flax_path: str):
    return [
        (f"{torch_mod}.weight", f"{flax_path}/kernel", _T),
        (f"{torch_mod}.bias", f"{flax_path}/bias", _ID),
    ]


def _ln(torch_mod: str, flax_path: str):
    return [
        (f"{torch_mod}.weight", f"{flax_path}/scale", _ID),
        (f"{torch_mod}.bias", f"{flax_path}/bias", _ID),
    ]


def framediff_mapping(cfg: FrameDiffConfig):
    """(torch key, flax path, transform) triplets for every *used* tensor.

    The vestigial ``linear_rbf`` / ``torsion_pred.linear_3`` checkpoint keys
    (reference TODOs, unused in its forward) have no Flax counterpart and are
    listed by :func:`framediff_unused_keys` instead.
    """
    m = []
    for emb in ("node_embedder", "edge_embedder"):
        for i, li in ((0, 0), (2, 1), (4, 2)):
            m += _linear(f"embedding_layer.{emb}.{i}", f"embedder/{emb}/linear_{li}")
        m += _ln(f"embedding_layer.{emb}.5", f"embedder/{emb}/ln")
    tr = "score_model.trunk"
    for b in range(cfg.num_blocks):
        ipa_t, ipa_f = f"{tr}.ipa_{b}", f"ipa_{b}"
        for lin in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points",
                    "linear_b", "down_z", "linear_out"):
            m += _linear(f"{ipa_t}.{lin}", f"{ipa_f}/{lin}")
        m += [(f"{ipa_t}.head_weights", f"{ipa_f}/head_weights", _ID)]
        m += _ln(f"{tr}.ipa_ln_{b}", f"ipa_ln_{b}")
        m += _linear(f"{tr}.skip_embed_{b}", f"skip_embed_{b}")
        for l in range(cfg.seq_tfmr_num_layers):
            tl = f"{tr}.seq_tfmr_{b}.layers.{l}"
            fl = f"seq_tfmr_{b}_layer_{l}"
            m += [
                (f"{tl}.self_attn.in_proj_weight", f"{fl}/in_proj/kernel", _T),
                (f"{tl}.self_attn.in_proj_bias", f"{fl}/in_proj/bias", _ID),
            ]
            m += _linear(f"{tl}.self_attn.out_proj", f"{fl}/out_proj")
            m += _linear(f"{tl}.linear1", f"{fl}/linear1")
            m += _linear(f"{tl}.linear2", f"{fl}/linear2")
            m += _ln(f"{tl}.norm1", f"{fl}/norm1")
            m += _ln(f"{tl}.norm2", f"{fl}/norm2")
        m += _linear(f"{tr}.post_tfmr_{b}", f"post_tfmr_{b}")
        nt = f"{tr}.node_transition_{b}"
        for lin in ("linear_1", "linear_2", "linear_3"):
            m += _linear(f"{nt}.{lin}", f"node_transition_{b}/{lin}")
        m += _ln(f"{nt}.ln", f"node_transition_{b}/ln")
        m += _linear(f"{tr}.bb_update_{b}.linear", f"bb_update_{b}")
        if b < cfg.num_blocks - 1:
            et = f"{tr}.edge_transition_{b}"
            m += _linear(f"{et}.initial_embed", f"edge_transition_{b}/initial_embed")
            m += _linear(f"{et}.trunk.0", f"edge_transition_{b}/trunk_0")
            m += _linear(f"{et}.trunk.2", f"edge_transition_{b}/trunk_1")
            m += _linear(f"{et}.final_layer", f"edge_transition_{b}/final_layer")
            m += _ln(f"{et}.layer_norm", f"edge_transition_{b}/layer_norm")
    tp = "score_model.torsion_pred"
    for lin in ("linear_1", "linear_2", "linear_final"):
        m += _linear(f"{tp}.{lin}", f"torsion_pred/{lin}")
    return m


def framediff_unused_keys(cfg: FrameDiffConfig):
    """Checkpoint keys the reference forward itself never uses."""
    keys = []
    for b in range(cfg.num_blocks):
        keys += [
            f"score_model.trunk.ipa_{b}.linear_rbf.weight",
            f"score_model.trunk.ipa_{b}.linear_rbf.bias",
        ]
    keys += [
        "score_model.torsion_pred.linear_3.weight",
        "score_model.torsion_pred.linear_3.bias",
    ]
    return keys


# ---------------------------------------------------------------------------
# Proteus mapping
# ---------------------------------------------------------------------------


def _attn(torch_mod: str, flax_path: str, gating: bool = True):
    m = []
    for lin in ("linear_q", "linear_k", "linear_v"):  # bias-free
        m += [(f"{torch_mod}.{lin}.weight", f"{flax_path}/{lin}/kernel", _T)]
    if gating:
        m += _linear(f"{torch_mod}.linear_g", f"{flax_path}/linear_g")
    m += _linear(f"{torch_mod}.linear_o", f"{flax_path}/linear_o")
    return m


def _tri_mul(torch_mod: str, flax_path: str):
    m = []
    for lin in ("linear_a_p", "linear_a_g", "linear_b_p", "linear_b_g",
                "linear_g", "linear_z"):
        m += _linear(f"{torch_mod}.{lin}", f"{flax_path}/{lin}")
    m += _ln(f"{torch_mod}.layer_norm_in", f"{flax_path}/layer_norm_in")
    m += _ln(f"{torch_mod}.layer_norm_out", f"{flax_path}/layer_norm_out")
    return m


def _pair_transition(torch_mod: str, flax_path: str):
    m = _ln(f"{torch_mod}.layer_norm", f"{flax_path}/layer_norm")
    m += _linear(f"{torch_mod}.linear_1", f"{flax_path}/linear_1")
    m += _linear(f"{torch_mod}.linear_2", f"{flax_path}/linear_2")
    return m


def proteus_mapping(cfg):
    """(torch key, flax path, transform) for the Proteus ScoreNetwork.

    cfg: a ProteusConfig (``models/protein/proteus.py``)."""
    m = []
    emb = "embedding_layer"
    for e in ("node_embedder", "edge_embedder"):
        for i, li in ((0, 0), (2, 1), (4, 2)):
            m += _linear(f"{emb}.{e}.{i}", f"{emb}/{e}/linear_{li}")
        m += _ln(f"{emb}.{e}.5", f"{emb}/{e}/ln")
    for e in ("ss_embedder", "adjacency_embedder", "hotspot_embedder"):
        m += _linear(f"{emb}.{e}", f"{emb}/{e}")
    te_t, te_f = f"{emb}.template_embedder", f"{emb}/template_embedder"
    m += _linear(f"{te_t}.self_condition_s", f"{te_f}/self_condition_s")
    m += _linear(f"{te_t}.self_condition_z", f"{te_f}/self_condition_z")
    m += _linear(f"{te_t}.template_angle_embedder.linear_1",
                 f"{te_f}/template_angle_embedder/linear_1")
    m += _linear(f"{te_t}.template_angle_embedder.linear_2",
                 f"{te_f}/template_angle_embedder/linear_2")
    m += _linear(f"{te_t}.template_pair_embedder.linear",
                 f"{te_f}/template_pair_embedder/linear")
    ps_t, ps_f = f"{te_t}.template_pair_stack", f"{te_f}/template_pair_stack"
    m += _tri_mul(f"{ps_t}.tri_mul_out", f"{ps_f}/tri_mul_out")
    m += _tri_mul(f"{ps_t}.tri_mul_in", f"{ps_f}/tri_mul_in")
    m += _pair_transition(f"{ps_t}.pair_transition", f"{ps_f}/pair_transition")
    m += _ln(f"{ps_t}.layer_norm", f"{ps_f}/layer_norm")
    ce_t = f"{te_t}.template_cross_embedder"
    ce_f = f"{te_f}/template_cross_embedder"
    m += _attn(f"{ce_t}.template_pointwise_att.mha",
               f"{ce_f}/template_pointwise_att/mha", gating=False)
    m += _attn(f"{ce_t}.template_columnwise_attention.mha",
               f"{ce_f}/template_columnwise_attention/mha", gating=True)
    if cfg.struct2seq_enable:
        # the struct2seq cross embedder (the combiner heads under
        # embedding_layer.struct2seq_embedder.* are MPNNESM's: see
        # mpnn_esm_heads_mapping)
        se_t, se_f = f"{emb}.struct2seq_cross_embedder", f"{emb}/struct2seq_cross_embedder"
        m += _attn(f"{se_t}.template_pointwise_att.mha",
                   f"{se_f}/template_pointwise_att/mha", gating=False)
        m += _attn(f"{se_t}.template_columnwise_attention.mha",
                   f"{se_f}/template_columnwise_attention/mha", gating=True)

    tr = "score_model.trunk"
    for b in range(cfg.num_blocks):
        ipa_t, ipa_f = f"{tr}.ipa_{b}", f"ipa_{b}"
        for lin in ("linear_q", "linear_kv", "linear_q_points",
                    "linear_kv_points", "linear_b", "down_z", "linear_out"):
            m += _linear(f"{ipa_t}.{lin}", f"{ipa_f}/{lin}")
        m += [(f"{ipa_t}.head_weights", f"{ipa_f}/head_weights", _ID)]
        m += _ln(f"{tr}.ipa_ln_{b}", f"ipa_ln_{b}")
        m += _linear(f"{tr}.skip_embed_{b}", f"skip_embed_{b}")
        for l in range(cfg.seq_tfmr_num_layers):
            tl, fl = f"{tr}.seq_tfmr_{b}.layers.{l}", f"seq_tfmr_{b}_layer_{l}"
            m += [
                (f"{tl}.self_attn.in_proj_weight", f"{fl}/in_proj/kernel", _T),
                (f"{tl}.self_attn.in_proj_bias", f"{fl}/in_proj/bias", _ID),
            ]
            m += _linear(f"{tl}.self_attn.out_proj", f"{fl}/out_proj")
            m += _linear(f"{tl}.linear1", f"{fl}/linear1")
            m += _linear(f"{tl}.linear2", f"{fl}/linear2")
            m += _ln(f"{tl}.norm1", f"{fl}/norm1")
            m += _ln(f"{tl}.norm2", f"{fl}/norm2")
        m += _linear(f"{tr}.post_tfmr_{b}", f"post_tfmr_{b}")
        for lin in ("linear_1", "linear_2", "linear_3"):
            m += _linear(f"{tr}.node_transition_{b}.{lin}",
                         f"node_transition_{b}/{lin}")
        m += _ln(f"{tr}.node_transition_{b}.ln", f"node_transition_{b}/ln")
        m += _linear(f"{tr}.bb_update_{b}.linear", f"bb_update_{b}")
        if b < cfg.num_blocks - 1:
            et, ef = f"{tr}.edge_transition_{b}", f"edge_transition_{b}"
            for lin in ("proj_left", "proj_right", "to_gate", "emb_rbf"):
                m += _linear(f"{et}.{lin}", f"{ef}/{lin}")
            m += [(f"{et}.to_bias.weight", f"{ef}/to_bias/kernel", _T)]
            m += _tri_mul(f"{et}.tri_mul_out", f"{ef}/tri_mul_out")
            m += _tri_mul(f"{et}.tri_mul_in", f"{ef}/tri_mul_in")
            m += _attn(f"{et}.mha_start", f"{ef}/mha_start")
            m += _attn(f"{et}.mha_end", f"{ef}/mha_end")
            m += _ln(f"{et}.layer_norm", f"{ef}/layer_norm")
    for lin in ("linear_1", "linear_2", "linear_final"):
        m += _linear(f"score_model.torsion_pred.{lin}", f"torsion_pred/{lin}")
    for head in ("dist_head", "omega_head", "theta_head", "phi_head"):
        m += _linear(f"auxiliary_heads.{head}.linear", f"{head}/linear")
    return m


def proteus_unused_keys(cfg):
    """Checkpoint tensors the reference inference forward never uses."""
    keys = ["score_model.torsion_pred.linear_3.weight",
            "score_model.torsion_pred.linear_3.bias"]
    for b in range(cfg.num_blocks):
        keys += [
            f"score_model.trunk.ipa_{b}.linear_rbf.weight",
            f"score_model.trunk.ipa_{b}.linear_rbf.bias",
        ]
        if b < cfg.num_blocks - 1:
            # LocalTriangleAttentionNew declares pair_transition but never
            # calls it (ipa_pytorch.py:284-287 vs 391-417)
            pt = f"score_model.trunk.edge_transition_{b}.pair_transition"
            keys += [
                f"{pt}.layer_norm.weight", f"{pt}.layer_norm.bias",
                f"{pt}.linear_1.weight", f"{pt}.linear_1.bias",
                f"{pt}.linear_2.weight", f"{pt}.linear_2.bias",
            ]
    return keys


# ---------------------------------------------------------------------------
# struct2seq: CA ProteinMPNN, ESM2 and the MPNN_ESM combiner heads
# ---------------------------------------------------------------------------


def mpnn_mapping(cfg):
    """CA ProteinMPNN state_dict -> Flax ``ProteinMPNNCA`` paths (cfg:
    ``struct2seq.MPNNConfig``)."""
    m = _linear("features.embeddings.linear", "features/embeddings/linear")
    m += [("features.edge_embedding.weight", "features/edge_embedding/kernel", _T)]
    m += _ln("features.norm_edges", "features/norm_edges")
    m += _linear("W_e", "W_e")
    m += [("W_s.weight", "W_s/embedding", _ID)]
    for i in range(cfg.num_encoder_layers):
        t, f = f"encoder_layers.{i}", f"encoder_layers_{i}"
        for lin in ("W1", "W2", "W3", "W11", "W12", "W13"):
            m += _linear(f"{t}.{lin}", f"{f}/{lin}")
        for n_ in ("norm1", "norm2", "norm3"):
            m += _ln(f"{t}.{n_}", f"{f}/{n_}")
        m += _linear(f"{t}.dense.W_in", f"{f}/dense/W_in")
        m += _linear(f"{t}.dense.W_out", f"{f}/dense/W_out")
    for i in range(cfg.num_decoder_layers):
        t, f = f"decoder_layers.{i}", f"decoder_layers_{i}"
        for lin in ("W1", "W2", "W3"):
            m += _linear(f"{t}.{lin}", f"{f}/{lin}")
        for n_ in ("norm1", "norm2"):
            m += _ln(f"{t}.{n_}", f"{f}/{n_}")
        m += _linear(f"{t}.dense.W_in", f"{f}/dense/W_in")
        m += _linear(f"{t}.dense.W_out", f"{f}/dense/W_out")
    return m + _linear("W_out", "W_out")


def mpnn_unused_keys(cfg):
    """Declared but unused in the reference CA forward: ``W_v`` (h_V starts
    from zeros) and the features' ``node_embedding`` / ``norm_nodes``."""
    return ["W_v.weight", "W_v.bias", "features.node_embedding.weight",
            "features.norm_nodes.weight", "features.norm_nodes.bias"]


def load_mpnn_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """A ProteinMPNN CA weights file (``v_48_020.pt``, a torch pickle
    ``{'num_edges': k, 'model_state_dict': ...}``): (state_dict, k)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: torch.as_tensor(v).detach() for k, v in ckpt["model_state_dict"].items()}
    return sd, int(ckpt.get("num_edges", 48))


def esm2_mapping(cfg):
    """transformers ``EsmModel`` state_dict -> Flax ``ESM2`` paths (cfg:
    ``struct2seq.ESM2Config``)."""
    m = [("embeddings.word_embeddings.weight", "embed_tokens/embedding", _ID)]
    for i in range(cfg.num_layers):
        t, f = f"encoder.layer.{i}", f"layer_{i}"
        m += _linear(f"{t}.attention.self.query", f"{f}/q")
        m += _linear(f"{t}.attention.self.key", f"{f}/k")
        m += _linear(f"{t}.attention.self.value", f"{f}/v")
        m += _linear(f"{t}.attention.output.dense", f"{f}/out")
        m += _ln(f"{t}.attention.LayerNorm", f"{f}/attn_ln")
        m += _linear(f"{t}.intermediate.dense", f"{f}/fc1")
        m += _linear(f"{t}.output.dense", f"{f}/fc2")
        m += _ln(f"{t}.LayerNorm", f"{f}/ffn_ln")
    return m + _ln("encoder.emb_layer_norm_after", "emb_layer_norm_after")


def esm2_unused_keys(cfg):
    """An ``EsmModel``'s position ids, rotary tables and contact head, which
    MPNN_ESM does not read (it takes the raw attention maps)."""
    return (["embeddings.position_ids", "contact_head.regression.weight",
             "contact_head.regression.bias"]
            + [f"encoder.layer.{i}.attention.self.rotary_embeddings.inv_freq"
               for i in range(cfg.num_layers)])


def load_esm2_state_dict(esm, sd: Dict[str, torch.Tensor]):
    """Load an ``EsmModel`` state_dict into the port's ``ESM2`` (strict, the
    unused keys dropped); returns ``esm``."""
    unused = set(esm2_unused_keys(esm.cfg))
    esm.load_state_dict({k: v for k, v in sd.items() if k not in unused}, strict=True)
    return esm


def load_esm2_snapshot(path: str):
    """A local transformers ``EsmModel`` snapshot directory (e.g.
    esm2_t33_650M_UR50D): (state_dict, ``struct2seq.ESM2Config``). Local
    files only; transformers is imported here."""
    from transformers.models.esm import EsmModel

    from .struct2seq import ESM2Config

    hf = EsmModel.from_pretrained(path, local_files_only=True, add_pooling_layer=False)
    c = hf.config
    cfg = ESM2Config(vocab_size=int(c.vocab_size), embed_dim=int(c.hidden_size),
                     num_layers=int(c.num_hidden_layers),
                     attention_heads=int(c.num_attention_heads),
                     intermediate_dim=int(c.intermediate_size),
                     token_dropout=bool(c.token_dropout), layer_norm_eps=float(c.layer_norm_eps))
    return {k: v.detach().float() for k, v in hf.state_dict().items()}, cfg


STRUCT2SEQ_PREFIX = "embedding_layer.struct2seq_embedder."


def mpnn_esm_heads_mapping():
    """The four trained combiner heads a Proteus checkpoint carries for
    MPNN_ESM (keys relative to ``STRUCT2SEQ_PREFIX``) -> Flax ``MPNNESM``
    paths."""
    return [("esm_s_combine", "esm_s_combine", _ID), ("esm_p_combine", "esm_p_combine", _ID),
            ("esm_s_mlp.0.weight", "esm_s_mlp_ln/scale", _ID),
            ("esm_s_mlp.0.bias", "esm_s_mlp_ln/bias", _ID),
            *_linear("esm_s_mlp.1", "esm_s_mlp_0"), *_linear("esm_s_mlp.3", "esm_s_mlp_1"),
            *_linear("esm_p_mlp", "esm_p_mlp")]


def extract_struct2seq_heads(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The MPNN_ESM combiner heads of a Proteus state_dict, keyed relative to
    ``STRUCT2SEQ_PREFIX``."""
    return {k[len(STRUCT2SEQ_PREFIX):]: v for k, v in sd.items()
            if k.startswith(STRUCT2SEQ_PREFIX)}
