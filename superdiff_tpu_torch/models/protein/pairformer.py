"""AF2 / openfold pair-representation primitives (port of
``superdiff_tpu/models/protein/pairformer.py``), under the reference
modules' parameter names: gated attention with a bias list, triangle
multiplication (outgoing / incoming), the pair transition, the light
template pair-stack block, template pointwise / column-wise attention and
the template angle / pair embedders. The reference's dropouts are no-ops
at inference and are left out.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..from_jax import flax_zeros


class GatedAttention(nn.Module):
    """AF2 attention with a bias list and sigmoid gating."""

    def __init__(self, c_q: int, c_k: int, c_v: int, c_hidden: int, no_heads: int,
                 gating: bool = True):
        super().__init__()
        self.c_hidden, self.no_heads, self.gating = c_hidden, no_heads, gating
        hc = c_hidden * no_heads
        self.linear_q = nn.Linear(c_q, hc, bias=False)
        self.linear_k = nn.Linear(c_k, hc, bias=False)
        self.linear_v = nn.Linear(c_v, hc, bias=False)
        if gating:
            self.linear_g = nn.Linear(c_q, hc)
        self.linear_o = flax_zeros(nn.Linear(hc, c_q))

    def forward(self, q_x, kv_x, biases: Optional[List[torch.Tensor]] = None):
        h, ch = self.no_heads, self.c_hidden
        q = self.linear_q(q_x)
        q = q.reshape(q.shape[:-1] + (h, ch)) / math.sqrt(ch)
        k = self.linear_k(kv_x)
        k = k.reshape(k.shape[:-1] + (h, ch))
        v = self.linear_v(kv_x)
        v = v.reshape(v.shape[:-1] + (h, ch))
        a = torch.einsum("...qhc,...khc->...hqk", q, k)  # [*, H, Q, K]
        for b in biases or []:
            a = a + b
        o = torch.einsum("...hqk,...khc->...qhc", torch.softmax(a, dim=-1), v)
        if self.gating:
            g = torch.sigmoid(self.linear_g(q_x))
            o = o * g.reshape(g.shape[:-1] + (h, ch))
        return self.linear_o(o.reshape(o.shape[:-2] + (h * ch,)))


class TriangleMultiplication(nn.Module):
    """Algorithms 11 / 12."""

    def __init__(self, c_z: int, c_hidden: int, outgoing: bool = True):
        super().__init__()
        self.outgoing = outgoing
        self.layer_norm_in = nn.LayerNorm(c_z, eps=1e-5)
        self.linear_a_p = nn.Linear(c_z, c_hidden)
        self.linear_a_g = nn.Linear(c_z, c_hidden)
        self.linear_b_p = nn.Linear(c_z, c_hidden)
        self.linear_b_g = nn.Linear(c_z, c_hidden)
        self.layer_norm_out = nn.LayerNorm(c_hidden, eps=1e-5)
        self.linear_z = flax_zeros(nn.Linear(c_hidden, c_z))
        self.linear_g = nn.Linear(c_z, c_z)

    def forward(self, z, mask=None):
        if mask is None:
            mask = torch.ones(z.shape[:-1], dtype=z.dtype, device=z.device)
        mask = mask[..., None]
        z = self.layer_norm_in(z)
        a = self.linear_a_p(z) * torch.sigmoid(self.linear_a_g(z)) * mask
        b = self.linear_b_p(z) * torch.sigmoid(self.linear_b_g(z)) * mask
        if self.outgoing:
            x = torch.einsum("...ikc,...jkc->...ijc", a, b)
        else:
            x = torch.einsum("...kic,...kjc->...ijc", a, b)
        x = self.linear_z(self.layer_norm_out(x))
        return x * torch.sigmoid(self.linear_g(z))


class PairTransition(nn.Module):
    def __init__(self, c_z: int, n: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c_z, eps=1e-5)
        self.linear_1 = nn.Linear(c_z, n * c_z)
        self.linear_2 = flax_zeros(nn.Linear(n * c_z, c_z))

    def forward(self, z, mask=None):
        if mask is None:
            mask = torch.ones(z.shape[:-1], dtype=z.dtype, device=z.device)
        z = F.relu(self.linear_1(self.layer_norm(z)))
        return self.linear_2(z) * mask[..., None]


class LightTemplatePairStackBlock(nn.Module):
    """Per-template triangle multiplications and transition, final LN.
    z: (B, S_t, N, N, C_t), mask: (B, S_t or 1, N, N). The templates run
    batched (the reference loops over them; the same math)."""

    def __init__(self, c_t: int, c_hidden_tri_mul: int, pair_transition_n: int):
        super().__init__()
        self.tri_mul_out = TriangleMultiplication(c_t, c_hidden_tri_mul, outgoing=True)
        self.tri_mul_in = TriangleMultiplication(c_t, c_hidden_tri_mul, outgoing=False)
        self.pair_transition = PairTransition(c_t, pair_transition_n)
        self.layer_norm = nn.LayerNorm(c_t, eps=1e-5)

    def forward(self, z, mask):
        if mask.shape[-3] == 1:
            mask = mask.expand(z.shape[:-1])
        z = z + self.tri_mul_out(z, mask)
        z = z + self.tri_mul_in(z, mask)
        z = z + self.pair_transition(z, mask)
        return self.layer_norm(z)


class TemplatePointwiseAttention(nn.Module):
    """Algorithm 17: per-pair attention over templates."""

    def __init__(self, c_t: int, c_z: int, c_hidden: int, no_heads: int, inf: float = 1e9):
        super().__init__()
        self.inf = inf
        self.mha = GatedAttention(c_z, c_t, c_t, c_hidden, no_heads, gating=False)

    def forward(self, t, z, template_mask=None):
        # t: (B, S_t, N, N, C_t); z: (B, N, N, C_z)
        if template_mask is None:
            template_mask = torch.ones(t.shape[:-3], dtype=t.dtype, device=t.device)
        bias = self.inf * (template_mask[..., None, None, None, None, :] - 1.0)
        out = self.mha(z[..., None, :], torch.movedim(t, -4, -2), biases=[bias])
        return out[..., 0, :]


class TemplateColumnWiseAttention(nn.Module):
    """Per-residue attention over templates."""

    def __init__(self, c_in: int, c_hidden: int, no_heads: int, inf: float = 1e9):
        super().__init__()
        self.inf = inf
        self.mha = GatedAttention(c_in, c_in, c_in, c_hidden, no_heads, gating=True)

    def forward(self, t, s, template_mask):
        # t: (B, S_t, N, C_s); s: (B, N, C_s)
        bias = self.inf * (template_mask[..., None, None, None, :] - 1.0)
        out = self.mha(s[..., None, :], torch.movedim(t, -3, -2), biases=[bias])
        return out[..., 0, :]


class TemplateAngleEmbedder(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.linear_1 = nn.Linear(c_in, c_out)
        self.linear_2 = nn.Linear(c_out, c_out)

    def forward(self, x):
        return self.linear_2(F.relu(self.linear_1(x)))


class TemplatePairEmbedder(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out)

    def forward(self, x):
        return self.linear(x)
