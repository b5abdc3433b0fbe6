"""Stable-Diffusion 1.x conditional UNet (port of ``superdiff_tpu/models/sd/unet.py``).

Public layout as in the JAX package: latents NHWC (B, H/8, W/8, 4) in,
fp32 NHWC eps out; contexts (B, 77, 768). Inside, activations are NCHW
tensors in ``channels_last`` memory, so the (B, H*W, C) token view of the
transformer blocks is free and cuDNN runs its NHWC convolutions.

Submodules carry the Flax module names (``down_0_res_0``, ``mid_attn``,
``up_2_upsample`` ...), so ``from_jax`` maps a Flax parameter tree onto the
``state_dict`` path by path. Linear and conv weights live in the compute
dtype (the JAX modules cast their fp32 params at every use); norm params and
the subpixel upsampler's 3x3 taps stay fp32.

Routing matches the JAX defaults (``attn_impl="flash_eod"``,
``ffn_impl="fused"``, ``upsample_impl="subpixel"``): self-attention over
more than 256 tokens goes through :func:`flash_mha_eod`; the 256- and
64-token self-attention and the 77-token cross-attention stay plain fp32
softmax einsum, as the JAX package sends them to its einsum reference; every
FFN sub-block is :func:`geglu_ffn_block`.

**Conditioning dedup**: when ``context.shape[0]`` is a multiple g of the
latent batch, the latents are shared by g conditioning groups (group-major).
Everything before the first cross-attention runs once; the batch is tiled
where context first enters (``attn2``), in the time embedding, in the
transformer residual and in the skips.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import flash_mha_eod
from ...ops.geglu_ffn import geglu_ffn_block
from ..unet import GroupNorm32, LayerNorm32


def sd_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0):
    """Diffusers ``Timesteps``: exponent ``arange(half)/half``, cos first."""
    half = dim // 2
    log_max = torch.log(torch.tensor(max_period, dtype=torch.float32))
    freqs = torch.exp(-log_max * torch.arange(half, dtype=torch.float32) / half)
    args = t.float().reshape(-1, 1) * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    """SD-1.x defaults (CompVis/stable-diffusion-v1-4 unet/config.json)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # heads per attention (SD1.x: 8 heads)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    # 'subpixel': one 2x2 conv with 4x the channels on the small grid plus a
    # phase interleave; 'repeat': nearest 2x repeat + 3x3 conv. Same params.
    upsample_impl: str = "subpixel"

    @staticmethod
    def tiny() -> "SDUNetConfig":
        """Small config for tests: same topology, 1/16 width."""
        return SDUNetConfig(
            block_out_channels=(32, 64, 64, 64),
            cross_attention_dim=64,
            attention_head_dim=4,
        )


def _linear(i, o, dtype, bias=True):
    return nn.Linear(i, o, bias=bias, dtype=dtype)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None."""

    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None,
                 dtype=torch.bfloat16):
        super().__init__()
        ctx_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = _linear(query_dim, query_dim, dtype, bias=False)
        self.to_k = _linear(ctx_dim, query_dim, dtype, bias=False)
        self.to_v = _linear(ctx_dim, query_dim, dtype, bias=False)
        self.to_out = _linear(query_dim, query_dim, dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        x = x.to(self.to_q.weight.dtype)
        b, l, c = x.shape
        nh = self.heads
        hd = c // nh
        if context is None and l > 256:
            # long self-attention rows: one packed projection into the
            # kernel's d-major layout (q, v (B,H,D,L); k a (B,H,L,D) view)
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
            qkv = F.linear(x, w).view(b, l, 3, nh, hd)
            qt = qkv[:, :, 0].permute(0, 2, 3, 1).contiguous()
            k = qkv[:, :, 1].permute(0, 2, 1, 3)
            vt = qkv[:, :, 2].permute(0, 2, 3, 1).contiguous()
            ot = flash_mha_eod(qt, k, vt)
            return self.to_out(ot.permute(0, 3, 1, 2).reshape(b, l, c))
        ctx = x if context is None else context.to(x.dtype)
        q = self.to_q(x).view(b, l, nh, hd)
        k = self.to_k(ctx).view(b, -1, nh, hd)
        v = self.to_v(ctx).view(b, -1, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        attn = torch.softmax(logits * hd**-0.5, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, l, c)
        return self.to_out(out)


class _GEGLUProj(nn.Module):
    """Holds the GEGLU projection as ``proj`` (Linear C -> 2F, value half
    first), the Flax ``ff_geglu/proj`` path."""

    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.proj = _linear(dim, 2 * hidden, dtype)


class TransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> fused LN + GEGLU FFN, pre-norm residuals."""

    def __init__(self, dim: int, heads: int, context_dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = CrossAttention(dim, heads, dtype=dtype)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim, dtype=dtype)
        self.norm3 = LayerNorm32(dim)
        self.ff_geglu = _GEGLUProj(dim, 4 * dim, dtype)
        self.ff_out = _linear(4 * dim, dim, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        if context.shape[0] != x.shape[0]:
            # conditioning dedup: expand group-major where context enters
            x = x.repeat(context.shape[0] // x.shape[0], 1, 1)
        x = x + self.attn2(self.norm2(x), context)
        proj = self.ff_geglu.proj
        return geglu_ffn_block(
            x.contiguous(), self.norm3.weight, self.norm3.bias, proj.weight,
            proj.bias, self.ff_out.weight, self.ff_out.bias, eps=self.norm3.eps)


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> transformer block -> proj_out, residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, dtype=torch.bfloat16):
        super().__init__()
        # diffusers Transformer2DModel input GroupNorm uses eps 1e-6
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = _linear(channels, channels, dtype)
        self.block_0 = TransformerBlock(channels, heads, context_dim, dtype)
        self.proj_out = _linear(channels, channels, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        z = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        z = self.proj_out(self.block_0(self.proj_in(z), context))
        # the batch may have grown inside the block (conditioning dedup)
        z = z.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        if z.shape[0] != b:
            x = x.repeat(z.shape[0] // b, 1, 1, 1)
        return z + x


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.time_emb_proj = _linear(temb_ch, out_ch, dtype)
        self.norm2 = GroupNorm32(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype)
        # the JAX package's _Conv1x1 (a dot for GSPMD's sake) is a 1x1 conv
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1, dtype=dtype)
                              if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        te = self.time_emb_proj(F.silu(temb))
        if te.shape[0] != h.shape[0]:
            # conditioning dedup: all groups share t, so the tile is exact
            te = te.repeat(h.shape[0] // te.shape[0], 1)
        h = self.conv2(F.silu(self.norm2(h + te[:, :, None, None])))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


# per axis: phase 0 reads source offsets (-1) | (0, +1), phase 1 (-1, 0) | (+1)
_PHASE_TAPS = torch.tensor([[[1, 0, 0], [0, 1, 1]], [[1, 1, 0], [0, 0, 1]]],
                           dtype=torch.float32)


class SubpixelUpsample(nn.Conv2d):
    """Nearest 2x upsample + 3x3 conv as ONE 2x2 conv on the small grid.

    Each output phase (di, dj) of the upsampled 3x3 conv touches only two
    source rows and columns, so its taps fold into a 2x2 kernel; the four
    phase kernels run as one conv with 4x the output channels at padding 1
    (phase d reads output index i + d) and are interleaved. The weight is
    the 3x3 conv's (fp32, OIHW), so :meth:`repeat_forward` computes the
    literal repeat + conv form from the same parameters.
    """

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, padding=1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.out_channels
        b, _, h, w = x.shape
        ms = _PHASE_TAPS.to(x.device)
        k4 = torch.einsum("dau,ebv,fcuv->defcab", ms, ms, self.weight.float())
        k4 = k4.reshape(4 * f, -1, 2, 2).to(x.dtype)
        y = F.conv2d(x, k4, self.bias.repeat(4).to(x.dtype), padding=1)
        rows = [
            torch.stack([y[:, (2 * di + dj) * f:(2 * di + dj + 1) * f,
                           di:h + di, dj:w + dj] for dj in (0, 1)], dim=-1)
            for di in (0, 1)
        ]  # each (B, F, H, W, 2)
        return torch.stack(rows, dim=3).reshape(b, f, 2 * h, 2 * w)

    def repeat_forward(self, x: torch.Tensor) -> torch.Tensor:
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return F.conv2d(up, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=1)


class SDUNet(nn.Module):
    """UNet2DConditionModel equivalent: (latents NHWC, t, context) -> eps NHWC fp32."""

    def __init__(self, config: SDUNetConfig = SDUNetConfig(), dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        ch0 = cfg.block_out_channels[0]
        temb_ch = 4 * ch0
        heads, ctx_dim = cfg.attention_head_dim, cfg.cross_attention_dim
        self.time_embed_1 = _linear(ch0, temb_ch, dtype)
        self.time_embed_2 = _linear(temb_ch, temb_ch, dtype)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, dtype=dtype)
        n = len(cfg.block_out_channels)
        ch, skips = ch0, [ch0]
        for i, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(ch, out_ch, temb_ch, dtype))
                ch = out_ch
                if block_type == "CrossAttnDownBlock2D":
                    self.add_module(f"down_{i}_attn_{j}",
                                    SpatialTransformer(ch, heads, ctx_dim, dtype))
                skips.append(ch)
            if i != n - 1:
                # symmetric stride-2 padding, as torch's Downsample2D
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock2D(ch, ch, temb_ch, dtype)
        self.mid_attn = SpatialTransformer(ch, heads, ctx_dim, dtype)
        self.mid_res_1 = ResnetBlock2D(ch, ch, temb_ch, dtype)
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = cfg.block_out_channels[n - 1 - i]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock2D(ch + skips.pop(), out_ch, temb_ch, dtype))
                ch = out_ch
                if block_type == "CrossAttnUpBlock2D":
                    self.add_module(f"up_{i}_attn_{j}",
                                    SpatialTransformer(ch, heads, ctx_dim, dtype))
            if i != n - 1:
                self.add_module(f"up_{i}_upsample", SubpixelUpsample(ch, ch))
        self.norm_out = GroupNorm32(ch)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, t, context: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.config, self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        temb = sd_timestep_embedding(t.reshape(-1).expand(x.shape[0]),
                                     cfg.block_out_channels[0])
        temb = self.time_embed_2(F.silu(self.time_embed_1(temb.to(dt))))
        context = context.to(dt)
        h = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(h)
        hs = [h]
        n = len(cfg.block_out_channels)
        for i, block_type in enumerate(cfg.down_block_types):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if block_type == "CrossAttnDownBlock2D":
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                hs.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                hs.append(h)
        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)
        for i, block_type in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                skip = hs.pop()
                if skip.shape[0] != h.shape[0]:
                    # skips recorded before the first cross-attention carry
                    # the deduped batch
                    skip = skip.repeat(h.shape[0] // skip.shape[0], 1, 1, 1)
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, skip], dim=1), temb)
                if block_type == "CrossAttnUpBlock2D":
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i != n - 1:
                up = getattr(self, f"up_{i}_upsample")
                h = up(h) if cfg.upsample_impl == "subpixel" else up.repeat_forward(h)
        assert not hs
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 1).float()

