"""CLIP text encoder (ViT-L/14 text tower) for SD conditioning (port of
``superdiff_tpu/models/sd/clip.py``), and SDXL's two towers.

12-layer causal transformer, width 768, 12 heads, quick-GELU, fp32
LayerNorms; returns the fp32 last hidden state (B, 77, 768). SDXL reads
its towers otherwise (``CLIPTextConfig.output="penultimate"``): the hidden
states before the last layer, without the final LayerNorm, and, where the
tower has a ``text_projection`` (OpenCLIP ViT-bigG/14: 32 layers, width
1280, exact gelu), the pooled embedding: the final LayerNorm at the first
end token, projected with no bias. A tower with no projection skips its
last layer there, whose output nothing reads. The tokenizer is the HF
``CLIPTokenizer`` when ``transformers`` and a local vocab exist, else the
JAX package's deterministic crc32 fallback.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import zlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..unet import LayerNorm32


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    hidden_act: str = "quick_gelu"  # or "gelu" (exact, OpenCLIP ViT-bigG/14)
    projection_dim: int = 0  # the pooled embedding's text_projection width; 0: none
    # "last": the final LayerNorm's states; "penultimate": (the states before
    # the last layer, the pooled embedding or None), as SDXL reads them
    output: str = "last"

    def __post_init__(self):
        if self.hidden_act not in _ACTS:
            raise ValueError(f"hidden_act {self.hidden_act!r}; one of {sorted(_ACTS)}")
        if self.output not in ("last", "penultimate"):
            raise ValueError(f"output {self.output!r}; 'last' or 'penultimate'")

    @property
    def eos_id(self) -> int:
        """The end token's id (the crc32 fallback's, for a small vocabulary)."""
        return Tokenizer.EOS if Tokenizer.EOS < self.vocab_size else 2

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4)

    @staticmethod
    def sdxl_l() -> "CLIPTextConfig":
        """SDXL base 1.0's ``text_encoder`` (CLIP ViT-L/14), read penultimate."""
        return CLIPTextConfig(output="penultimate")

    @staticmethod
    def sdxl_g() -> "CLIPTextConfig":
        """SDXL base 1.0's ``text_encoder_2`` (OpenCLIP ViT-bigG/14)."""
        return CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, hidden_act="gelu",
                              projection_dim=1280, output="penultimate")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


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
        self.act = _ACTS[cfg.hidden_act]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        h = self.act(self.fc1(self.layer_norm2(x).to(self.fc1.weight.dtype)))
        return x + self.fc2(h)


class CLIPTextEncoder(nn.Module):
    """token ids (B, L) int -> fp32 hidden states (B, L, hidden); with
    ``output="penultimate"`` (the states before the last layer, and the
    pooled embedding (B, projection_dim) or None), fp32."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg, dtype))
        self.final_layer_norm = LayerNorm32(cfg.hidden_size)
        if cfg.projection_dim:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                             dtype=dtype)

    def forward(self, input_ids: torch.Tensor):
        cfg = self.cfg
        l = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :l].to(self.dtype)
        causal = torch.triu(torch.full((l, l), -1e9, device=x.device), diagonal=1)[None, None]
        layers = [getattr(self, f"layer_{i}") for i in range(cfg.num_layers)]
        for layer in layers[:-1]:
            x = layer(x, causal)
        if cfg.output == "penultimate" and not cfg.projection_dim:
            return x.float(), None  # nothing reads the last layer's output
        penultimate, x = x, layers[-1](x, causal)
        if cfg.output == "last":
            return self.final_layer_norm(x)
        # the first end token of each row
        eos = (input_ids == cfg.eos_id).int().argmax(dim=1)
        pooled = self.final_layer_norm(x[torch.arange(x.shape[0], device=x.device), eos])
        return penultimate.float(), self.text_projection(pooled.to(self.dtype)).float()


class Tokenizer:
    """HF CLIPTokenizer when available, deterministic crc32 fallback otherwise.
    ``pad_id``: the fallback's padding after the end token (None: the end
    token, as CLIP-L's tokenizer pads; 0, "!", as SDXL's ``tokenizer_2``)."""

    # CLIP's real special-token ids, used by the fallback too
    BOS = 49406
    EOS = 49407

    def __init__(self, cfg: CLIPTextConfig, hf_path: Optional[str] = None,
                 pad_id: Optional[int] = None):
        self.cfg, self.pad_id = cfg, pad_id
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
        eos = c.eos_id
        pad = eos if self.pad_id is None else self.pad_id
        ids = np.full((len(prompts), c.max_length), pad, dtype=np.int32)
        ids[:, 0] = bos
        for i, p in enumerate(prompts):
            toks = [3 + (zlib.crc32(w.encode()) % (c.vocab_size - 4))
                    for w in p.lower().split()][: c.max_length - 2]
            ids[i, 1:1 + len(toks)] = toks
            ids[i, 1 + len(toks)] = eos
        return ids
