"""Tensor-parallel Stable-Diffusion UNet inference over a mesh axis (port
of ``superdiff_tpu/parallel/tp.py``).

The transformer tier of the SD UNet is split Megatron-style over a ``tp``
axis, so one latent's forward spans several ranks, while the conv tier
stays replicated (the ``data`` axis already splits the batch). JAX lets
GSPMD place the collectives; here :func:`place_tp` slices the weights in
place and swaps each split ``Linear`` for a layer that runs its own
collective. The rules are JAX's (``_TP_RULES``), on the port's
``state_dict`` names and ``(out, in)`` weights:

* ``attn1`` / ``attn2``: ``to_q``, ``to_k``, ``to_v`` column-parallel
  (each rank computes its own heads), ``to_out`` row-parallel;
* the GEGLU FFN: ``ff_geglu.proj`` column-parallel over its hidden F, each
  rank keeping the value rows and the gate rows of the same F slice (the
  weight is ``(2F, C)``, value half first: a plain row slice would hand
  rank 0 only value rows), ``ff_out`` row-parallel;
* ``proj_in`` column-parallel, ``proj_out`` row-parallel.

Norm scales are replicated. A row-parallel bias is replicated and added
once, after the reduce; a column-parallel bias is cut with its weight's
rows (a rank's outputs need only their own entries). A weight whose split
dimension does not divide by ``tp`` stays replicated (JAX ``:77-83``);
an attention whose heads do not divide by ``tp``, or any of whose four
projections stays replicated, stays whole on every rank, as do the FFN
and the ``proj_in`` / ``proj_out`` pair on the same terms (GSPMD can
split a head or one weight alone; hand-placed collectives need the pair).

**Collectives.** Per spatial transformer: 1 all-gather (``proj_in``'s
output, so the residual stream and every LayerNorm are whole on each
rank) and 4 all-reduces (after ``attn1.to_out``, ``attn2.to_out``,
``ff_out`` and ``proj_out``, whose input slice is this rank's channels of
the whole stream), all of activation size. GSPMD's count for the same
forward is 4 all-reduces and 3 all-gathers (JAX's
``test_tp_collective_counts``): it keeps the stream channel-split and
gathers it before each of the three sub-blocks.

**Lowering.** As in JAX, TP runs on the einsum lowering
(``SDUNetConfig(attn_impl="einsum", ffn_impl="einsum")``): the port's
kernels take whole heads and whole FFN weights. Handed a kernel
configuration at ``tp > 1``, :func:`place_tp` raises ``ValueError``; at
``tp == 1`` it leaves such a module as it is (one rank runs the whole
layer on its kernels). On the einsum lowering it installs the split
layers at every ``tp``, 1 included.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh

# (state_dict name regex, spec over the (out, in) weight) -- first match
# wins; weights only (biases and norm scales replicated)
_TP_RULES = (
    # attention: column-parallel q/k/v (splits heads), row-parallel out
    (re.compile(r"attn\d\.to_[qkv]\.weight$"), ("tp", None)),
    (re.compile(r"attn\d\.to_out\.weight$"), (None, "tp")),
    # GEGLU FFN: column-parallel over F (value and gate halves each),
    # row-parallel out-projection
    (re.compile(r"ff_geglu\.proj\.weight$"), ("tp", None)),
    (re.compile(r"ff_out\.weight$"), (None, "tp")),
    # per-token projections around the transformer block
    (re.compile(r"proj_in\.weight$"), ("tp", None)),
    (re.compile(r"proj_out\.weight$"), (None, "tp")),
)


def _named(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, tuple):  # (params, buffers) of models.ensemble.stack_params
        params = params[0]
    return params


def _shardings_from_rules(params: Any, mesh: Mesh, prefix: tuple) -> dict:
    """name -> spec tuple; ``prefix`` is prepended to every spec (and to
    the replicated default ``()``), so the same rules serve a stacked
    ensemble whose leaves carry a leading model axis."""
    if "tp" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'tp' axis")
    tp = mesh.shape["tp"]
    out = {}
    for name, leaf in _named(params).items():
        spec = ()
        for rx, rule in _TP_RULES:
            if rx.search(name):
                dim = rule.index("tp") + len(prefix)
                size = leaf.shape[dim] // (2 if "ff_geglu" in name else 1)
                if size % tp == 0:
                    spec = rule
                break
        out[name] = prefix + spec
    return out


def sd_tp_shardings(params: Any, mesh: Mesh) -> dict:
    """``{state_dict name: spec}`` for an SD UNet (a module or its named
    parameters): the transformer weights split over the mesh's ``tp`` axis
    by the Megatron pairing above (``("tp", None)`` column-, ``(None,
    "tp")`` row-parallel), everything else ``()``, replicated."""
    return _shardings_from_rules(params, mesh, prefix=())


def sd_tp_shardings_stacked(stacked_params: Any, mesh: Mesh) -> dict:
    """Specs for an ensemble-stacked SD UNet (``models.ensemble.stack_params``:
    a leading model axis on every leaf): the stack over ``model`` and each
    weight's tp rule one dim to the right, the 3-axis data x model x tp
    layout in which each denoiser's shards live on its own model group."""
    if "model" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'model' axis")
    return _shardings_from_rules(stacked_params, mesh, prefix=("model",))


class ColumnParallelLinear(nn.Module):
    """This rank's output rows of a Linear (and their bias entries);
    ``gather`` all-gathers the outputs over ``tp`` into the whole width."""

    def __init__(self, weight, bias, mesh: Mesh, gather: bool = False):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.mesh, self.gather = mesh, gather

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        return self.mesh.all_gather(y, "tp", dim=-1) if self.gather else y


class RowParallelLinear(nn.Module):
    """This rank's input columns of a Linear: the partial products are
    summed over ``tp`` and the (whole) bias is added after the reduce.
    ``slice_input``: the input is whole on every rank, take this rank's
    channels of it."""

    def __init__(self, weight, bias, mesh: Mesh, slice_input: bool = False):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.mesh, self.slice_input = mesh, slice_input

    def forward(self, x):
        if self.slice_input:
            k = self.weight.shape[1]
            i = self.mesh.coords["tp"]
            x = x[..., i * k:(i + 1) * k]
        y = self.mesh.all_reduce(F.linear(x, self.weight), "tp")
        return y if self.bias is None else y + self.bias


def _rows(w, tp, i, halves=1):
    """Rank ``i``'s rows of ``w``; ``halves=2`` takes the same slice of each
    half (GEGLU's value and gate) and stacks them, value first."""
    return torch.cat([h.chunk(tp, 0)[i] for h in w.chunk(halves, 0)]).contiguous()


def _column(lin: nn.Linear, mesh, halves=1, gather=False) -> ColumnParallelLinear:
    tp, i = mesh.shape["tp"], mesh.coords["tp"]
    bias = None if lin.bias is None else _rows(lin.bias.data, tp, i, halves)
    return ColumnParallelLinear(_rows(lin.weight.data, tp, i, halves), bias, mesh, gather)


def _row(lin: nn.Linear, mesh, slice_input=False) -> RowParallelLinear:
    tp, i = mesh.shape["tp"], mesh.coords["tp"]
    w = lin.weight.data.chunk(tp, 1)[i].contiguous()
    bias = None if lin.bias is None else lin.bias.data
    return RowParallelLinear(w, bias, mesh, slice_input)


def place_tp(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Split ``module``'s (an ``SDUNet``'s) transformer tier over the mesh's
    ``tp`` axis in place, by :func:`sd_tp_shardings`; returns it."""
    from ..models.sd.unet import CrossAttention, SpatialTransformer, TransformerBlock

    tp = mesh.shape["tp"]
    kernels = {m.attn_impl for m in module.modules() if isinstance(m, CrossAttention)}
    kernels |= {m.ffn_impl for m in module.modules() if isinstance(m, TransformerBlock)}
    if kernels - {"einsum"}:
        if tp > 1:
            raise ValueError(f"place_tp: tp={tp} runs on the einsum lowering "
                             f"(attn_impl / ffn_impl 'einsum'); got {sorted(kernels)}")
        return module
    specs = sd_tp_shardings(module, mesh)

    def split(prefix, *names):
        return all(specs[f"{prefix}{n}.weight"] != () for n in names)

    for path, st in module.named_modules():
        if not isinstance(st, SpatialTransformer):
            continue
        pre = f"{path}." if path else ""
        blk = st.block_0
        if split(pre, "proj_in", "proj_out"):
            st.proj_in = _column(st.proj_in, mesh, gather=True)
            st.proj_out = _row(st.proj_out, mesh, slice_input=True)
        for name in ("attn1", "attn2"):
            attn = getattr(blk, name)
            p = f"{pre}block_0.{name}."
            if attn.heads % tp == 0 and split(p, "to_q", "to_k", "to_v", "to_out"):
                attn.to_q, attn.to_k, attn.to_v = (_column(getattr(attn, n), mesh)
                                                   for n in ("to_q", "to_k", "to_v"))
                attn.to_out = _row(attn.to_out, mesh)
                attn.heads //= tp
        if split(f"{pre}block_0.", "ff_geglu.proj", "ff_out"):
            blk.ff_geglu.proj = _column(blk.ff_geglu.proj, mesh, halves=2)
            blk.ff_out = _row(blk.ff_out, mesh)
    return module


def make_tp_mesh(data: int, tp: int) -> Mesh:
    """A ('data', 'tp') mesh; tp innermost, so a latent's shards sit on
    neighbouring ranks (TP collectives run every layer, DP has none at
    inference)."""
    return Mesh((("data", data), ("tp", tp)))


def make_ensemble_tp_mesh(data: int, model: int, tp: int) -> Mesh:
    """A ('data', 'model', 'tp') mesh for composed-ensemble TP inference:
    tp innermost, the ensemble axis in the middle, data outermost."""
    return Mesh((("data", data), ("model", model), ("tp", tp)))
