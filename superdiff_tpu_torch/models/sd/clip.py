"""CLIP text encoder (ViT-L/14 text tower) for SD conditioning (port of
``superdiff_tpu/models/sd/clip.py``).

12-layer causal transformer, width 768, 12 heads, quick-GELU, fp32
LayerNorms; returns the fp32 last hidden state (B, 77, 768). The tokenizer
is the HF ``CLIPTokenizer`` when ``transformers`` and a local vocab exist,
else the JAX package's deterministic crc32 fallback.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import zlib
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..unet import LayerNorm32


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(c, c, dtype=dtype) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x.to(self.q_proj.weight.dtype)
        b, l, c = x.shape
        hd = c // self.heads
        q, k, v = (p(x).view(b, l, self.heads, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd**-0.5 + mask
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, l, c)
        return self.out_proj(out)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = LayerNorm32(c)
        self.self_attn = CLIPAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm32(c)
        self.fc1 = nn.Linear(c, 4 * c, dtype=dtype)
        self.fc2 = nn.Linear(4 * c, c, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        h = quick_gelu(self.fc1(self.layer_norm2(x).to(self.fc1.weight.dtype)))
        return x + self.fc2(h)


class CLIPTextEncoder(nn.Module):
    """token ids (B, L) int -> fp32 hidden states (B, L, hidden)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg, dtype))
        self.final_layer_norm = LayerNorm32(cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        l = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :l].to(self.dtype)
        causal = torch.triu(torch.full((l, l), -1e9, device=x.device), diagonal=1)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal[None, None])
        return self.final_layer_norm(x)


class Tokenizer:
    """HF CLIPTokenizer when available, deterministic crc32 fallback otherwise."""

    # CLIP's real special-token ids, used by the fallback too
    BOS = 49406
    EOS = 49407

    def __init__(self, cfg: CLIPTextConfig, hf_path: Optional[str] = None):
        self.cfg = cfg
        self._hf = None
        if hf_path:
            try:
                from transformers import CLIPTokenizer

                for candidate in (os.path.join(hf_path, "tokenizer"), hf_path):
                    if not os.path.isdir(candidate):
                        continue
                    try:
                        self._hf = CLIPTokenizer.from_pretrained(
                            candidate, local_files_only=True)
                        break
                    except Exception:
                        continue
            except Exception:
                self._hf = None
            if self._hf is None:
                warnings.warn(
                    f"No CLIPTokenizer found under {hf_path!r} (tried "
                    "'tokenizer/' subfolder and the root). Falling back to "
                    "hash-based fake tokens — text conditioning will be "
                    "GARBAGE with real weights.",
                    stacklevel=2,
                )

    def __call__(self, prompts: list[str]) -> np.ndarray:
        c = self.cfg
        if self._hf is not None:
            out = self._hf(prompts, padding="max_length", max_length=c.max_length,
                           truncation=True, return_tensors="np")
            return out["input_ids"].astype(np.int32)
        # fallback: bos, per-word crc32 tokens, eos, pad with eos
        bos = self.BOS if self.BOS < c.vocab_size else 1
        eos = self.EOS if self.EOS < c.vocab_size else 2
        ids = np.full((len(prompts), c.max_length), eos, dtype=np.int32)
        ids[:, 0] = bos
        for i, p in enumerate(prompts):
            toks = [3 + (zlib.crc32(w.encode()) % (c.vocab_size - 4))
                    for w in p.lower().split()][: c.max_length - 2]
            ids[i, 1:1 + len(toks)] = toks
            ids[i, 1 + len(toks)] = eos
        return ids
