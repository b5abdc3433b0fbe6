"""SD AutoencoderKL (port of ``VAEDecoder``, ``VAEEncoder`` and
``decode_to_uint8`` from ``superdiff_tpu/models/sd/vae.py``).

Decoder: latents NHWC in, fp32 NHWC images in [-1, 1] out. Encoder: NHWC
images in, fp32 NHWC (mean, logvar) out. NCHW ``channels_last`` inside.
Upsampling is the literal nearest 2x repeat + 3x3 conv, downsampling a
stride-2 3x3 conv padded (0, 1) per axis, and the mid attention is plain
single-head fp32-softmax attention, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..unet import GroupNorm32


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215  # SD-1.x latent scale

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(base_channels=32, channel_mults=(1, 2), layers_per_block=1)


def _conv3(i, o, dtype):
    return nn.Conv2d(i, o, 3, padding=1, dtype=dtype)


class VAEResnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = _conv3(in_ch, out_ch, dtype)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = _conv3(out_ch, out_ch, dtype)
        self.shortcut = nn.Conv2d(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class VAEAttn(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (
            nn.Linear(channels, channels, dtype=dtype) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        z = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.q(z), self.k(z), self.v(z)
        logits = torch.einsum("bqc,bkc->bqk", q, k).float() * c**-0.5
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.proj_out(torch.einsum("bqk,bkc->bqc", attn, v))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEDecoder(nn.Module):
    """latents (B, h, w, 4) NHWC -> images (B, 8h, 8w, 3) NHWC fp32."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), out_channels: int = 3,
                 dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        chs = [cfg.base_channels * m for m in cfg.channel_mults]
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1,
                                         dtype=dtype)
        self.conv_in = _conv3(cfg.latent_channels, chs[-1], dtype)
        self.mid_res_0 = VAEResnet(chs[-1], chs[-1], dtype)
        self.mid_attn = VAEAttn(chs[-1], dtype)
        self.mid_res_1 = VAEResnet(chs[-1], chs[-1], dtype)
        ch = chs[-1]
        for i, out_ch in enumerate(reversed(chs)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(ch, out_ch, dtype))
                ch = out_ch
            if i != len(chs) - 1:
                self.add_module(f"up_{i}_conv", _conv3(ch, ch, dtype))
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = _conv3(ch, out_channels, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = z.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(self.post_quant_conv(h))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        n = len(cfg.channel_mults)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i != n - 1:
                h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                h = getattr(self, f"up_{i}_conv")(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 1).float()


class VAEEncoder(nn.Module):
    """images (B, H, W, 3) NHWC -> (mean, logvar) concatenated, (B, H/8, W/8,
    2 * latent) NHWC fp32."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        chs = [cfg.base_channels * m for m in cfg.channel_mults]
        self.conv_in = _conv3(3, chs[0], dtype)
        ch = chs[0]
        for i, out_ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", VAEResnet(ch, out_ch, dtype))
                ch = out_ch
            if i != len(chs) - 1:
                self.add_module(f"down_{i}_conv", nn.Conv2d(ch, ch, 3, stride=2, dtype=dtype))
        self.mid_res_0 = VAEResnet(ch, ch, dtype)
        self.mid_attn = VAEAttn(ch, dtype)
        self.mid_res_1 = VAEResnet(ch, ch, dtype)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = _conv3(ch, 2 * cfg.latent_channels, dtype)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.cfg.channel_mults)
        h = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(h)
        for i in range(n):
            for j in range(self.cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i != n - 1:
                # diffusers' Downsample2D in the VAE encoder: pad 0 before and
                # 1 after each spatial axis, then the unpadded stride-2 conv
                h = getattr(self, f"down_{i}_conv")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        h = self.conv_out(F.silu(self.norm_out(h)))
        return self.quant_conv(h).permute(0, 2, 3, 1).float()


def decode_to_uint8(decoder: VAEDecoder, latents: torch.Tensor,
                    scaling_factor: float) -> torch.Tensor:
    """latents -> uint8 images (B, H, W, 3), as the JAX package computes them."""
    img = decoder(latents / scaling_factor)
    img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
    return (img * 255.0).to(torch.uint8)
