"""Stable-Diffusion 1.x conditional UNet (port of ``superdiff_tpu/models/sd/unet.py``),
and SDXL's (``SDUNetConfig.sdxl_base()``).

Public layout as in the JAX package: latents NHWC (B, H/8, W/8, 4) in,
fp32 NHWC eps out; contexts (B, 77, 768) (SDXL: (B, 77, 2048)). Inside, activations are NCHW
tensors in ``channels_last`` memory, so the (B, H*W, C) token view of the
transformer blocks is free and cuDNN runs its NHWC convolutions.

Submodules carry the Flax module names (``down_0_res_0``, ``mid_attn``,
``up_2_upsample`` ...), so ``from_jax`` maps a Flax parameter tree onto the
``state_dict`` path by path. Linear and conv weights live in the compute
dtype (the JAX modules cast their fp32 params at every use); norm params and
the subpixel upsampler's 3x3 taps stay fp32.

Attention routes by ``SDUNetConfig.attn_impl`` as in the JAX package
(default ``"flash_eod"``): self-attention over more than 256 tokens goes
through :func:`flash_mha_eod` (``flash_eod``, d-major projections) or
:func:`flash_mha_bhld` (``flash_eo``, (B,H,L,D) projections); every other
row of the flash family (``flash`` everywhere; the short self-attention rows
and the 77-token cross-attention of ``flash_eo`` / ``flash_eod``) through
:func:`flash_mha`, which sends kv <= 256 to plain attention. Which kernel a
row reaches is those entries' dispatch: at 512 px the 4096- and 1024-token
rows, at 768 px the 9216-token rows (online softmax), the 2304-token rows
(d-major) and the 576-token rows (head dim 160). ``flash_nat`` sends every
row, self and cross, through :func:`flash_mha` with ``native_long_kv=True``:
each row that fits one kv block reaches the packed-layout ``_kernel_mh_nat``
on views of the packed projections (at 768 px the 9216-token rows stay on
the online-softmax kernel). ``einsum`` is the explicit fp32 softmax and
``dpa`` one ``scaled_dot_product_attention`` call (no TPU kernel in JAX
either). ``ffn_impl`` as in JAX: ``"fused"`` (default) runs every FFN
sub-block through :func:`geglu_ffn_block`, ``"einsum"`` the plain fp32
LayerNorm, GEGLU projection, exact gelu and ``ff_out`` Linear over the same
parameters. ``upsample_impl`` as in JAX.

The timestep embedding's frequencies and the subpixel upsampler's phase
taps are non-persistent buffers, built once on the CPU when the module is
made (the state dict is unchanged): a forward copies nothing from the
host, so a sampler step can be captured in a CUDA graph.

**SDXL** (stabilityai/stable-diffusion-xl-base-1.0 ``unet/config.json``):
per-level transformer depth (``transformer_layers_per_block``; the mid
block takes the last level's) and head counts (``attention_head_dim`` per
level, as diffusers reads it), levels without attention at either end, and
the ``text_time`` added embedding: the six size ids through
``Timesteps(256)`` (cos first), concatenated with the pooled text
embedding (``text_embeds``), through ``add_embed_1``, SiLU, ``add_embed_2``
and added to the time embedding that every resnet reads.

**Conditioning dedup**: when ``context.shape[0]`` is a multiple g of the
latent batch, the latents are shared by g conditioning groups (group-major).
Everything before conditioning first enters runs once; the batch is tiled
there. Without the added embedding that is the first cross-attention
(``attn2``), and the time embedding, the transformer residual and the skips
are tiled where they meet the grown batch; with it the time embedding
differs per conditioning, so only ``conv_in`` runs once and its output is
tiled before the first resnet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import flash_mha, flash_mha_bhld, flash_mha_eod
from ...ops.geglu_ffn import geglu_ffn_block
from ..unet import GroupNorm32, LayerNorm32


def sd_timestep_freqs(dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """The embedding's (dim // 2,) fp32 frequencies, computed on the CPU."""
    half = dim // 2
    log_max = torch.log(torch.tensor(max_period, dtype=torch.float32, device="cpu"))
    return torch.exp(-log_max * torch.arange(half, dtype=torch.float32, device="cpu") / half)


def sd_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0,
                          freqs: Optional[torch.Tensor] = None):
    """Diffusers ``Timesteps``: exponent ``arange(half)/half``, cos first.
    ``freqs``: :func:`sd_timestep_freqs` already on ``t``'s device."""
    if freqs is None:
        freqs = sd_timestep_freqs(dim, max_period).to(t.device)
    args = t.float().reshape(-1, 1) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


ATTN_IMPLS = ("flash_eod", "flash_eo", "flash", "flash_nat", "einsum", "dpa")
FFN_IMPLS = ("fused", "einsum")


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    """SD-1.x defaults (CompVis/stable-diffusion-v1-4 unet/config.json)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # heads per attention (SD1.x: 8 heads), or one count per level (SDXL)
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    # transformer blocks per attention, or one count per level (SDXL)
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    # None, or "text_time" (SDXL): pooled text + size ids into the time embedding
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
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
    # attention kernel selection, see the module docstring
    attn_impl: str = "flash_eod"
    # 'fused': the geglu_ffn_block kernel; 'einsum': plain LN + GEGLU + Dense
    ffn_impl: str = "fused"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}; one of {ATTN_IMPLS}")
        if self.ffn_impl not in FFN_IMPLS:
            raise ValueError(f"ffn_impl {self.ffn_impl!r}; one of {FFN_IMPLS}")
        if self.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"addition_embed_type {self.addition_embed_type!r}; None or "
                             "'text_time'")
        n = len(self.block_out_channels)
        for name in ("attention_head_dim", "transformer_layers_per_block"):
            v = getattr(self, name)
            if not isinstance(v, int) and len(v) != n:
                raise ValueError(f"{name}: an int or one per level ({n}); got {v!r}")

    def level(self, name: str, i: int) -> int:
        """``attention_head_dim`` or ``transformer_layers_per_block`` at level ``i``."""
        v = getattr(self, name)
        return v if isinstance(v, int) else v[i]

    @property
    def added_embedding(self) -> bool:
        """Whether the forward takes pooled text and size ids (SDXL)."""
        return self.addition_embed_type == "text_time"

    @staticmethod
    def sdxl_base(**kw) -> "SDUNetConfig":
        """SDXL base 1.0 (stabilityai/stable-diffusion-xl-base-1.0
        ``unet/config.json``): 70 transformer blocks, head dim 64."""
        return SDUNetConfig(**{**dict(
            block_out_channels=(320, 640, 1280), cross_attention_dim=2048,
            attention_head_dim=(5, 10, 20), transformer_layers_per_block=(1, 2, 10),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            addition_embed_type="text_time"), **kw})

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


def _tile_count(big: str, rows: int, small: str, of: int) -> int:
    """The conditioning dedup's tile count where ``big`` (``rows`` rows)
    meets ``small`` (``of`` rows); raises unless ``rows`` is a whole
    multiple of ``of`` (a ``repeat`` by 0 or a remainder dropped)."""
    if of < 1 or rows < of or rows % of:
        raise ValueError(f"conditioning dedup: {rows} rows of {big} against {of} of {small}; "
                         "the first must be a whole multiple of the second")
    return rows // of


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None.
    ``attn_impl`` as in :class:`SDUNetConfig`."""

    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None,
                 dtype=torch.bfloat16, attn_impl: str = "flash_eod"):
        super().__init__()
        ctx_dim = context_dim or query_dim
        self.heads = heads
        self.attn_impl = attn_impl
        self.to_q = _linear(query_dim, query_dim, dtype, bias=False)
        self.to_k = _linear(ctx_dim, query_dim, dtype, bias=False)
        self.to_v = _linear(ctx_dim, query_dim, dtype, bias=False)
        self.to_out = _linear(query_dim, query_dim, dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        x = x.to(self.to_q.weight.dtype)
        b, l, _ = x.shape
        nh = self.heads
        # this rank's heads under tensor parallelism (parallel/tp.py)
        c = self.to_q.weight.shape[0]
        hd = c // nh
        impl = self.attn_impl
        if context is None and impl != "einsum":
            # self-attention: one packed projection, split per head
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
            q, k, v = F.linear(x, w).view(b, l, 3, nh, hd).unbind(2)
        else:
            ctx = x if context is None else context.to(x.dtype)
            q = self.to_q(x).view(b, l, nh, hd)
            k = self.to_k(ctx).view(b, -1, nh, hd)
            v = self.to_v(ctx).view(b, -1, nh, hd)
        long_self = context is None and l > 256
        if impl == "flash_eod" and long_self:
            # the kernel's d-major layout: q, v (B,H,D,L); k a (B,H,L,D) view
            ot = flash_mha_eod(q.permute(0, 2, 3, 1).contiguous(), k.permute(0, 2, 1, 3),
                               v.permute(0, 2, 3, 1).contiguous())
            out = ot.permute(0, 3, 1, 2)
        elif impl == "flash_eo" and long_self:
            # (B,H,L,D) views of the packed projection, taken as they are
            out = flash_mha_bhld(*(a.permute(0, 2, 1, 3) for a in (q, k, v))).permute(0, 2, 1, 3)
        elif impl.startswith("flash"):
            out = flash_mha(q, k, v, native_long_kv=impl == "flash_nat")
        elif impl == "dpa":
            out = F.scaled_dot_product_attention(
                *(a.transpose(1, 2) for a in (q, k, v))).transpose(1, 2)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
            attn = torch.softmax(logits * hd**-0.5, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.to_out(out.reshape(b, l, c))


class _GEGLUProj(nn.Module):
    """Holds the GEGLU projection as ``proj`` (Linear C -> 2F, value half
    first), the Flax ``ff_geglu/proj`` path."""

    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.proj = _linear(dim, 2 * hidden, dtype)


class TransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> LN + GEGLU FFN, pre-norm residuals; the
    FFN fused (``ffn_impl="fused"``) or plain (``"einsum"``)."""

    def __init__(self, dim: int, heads: int, context_dim: int, dtype=torch.bfloat16,
                 attn_impl: str = "flash_eod", ffn_impl: str = "fused"):
        super().__init__()
        self.ffn_impl = ffn_impl
        self.norm1 = LayerNorm32(dim)
        self.attn1 = CrossAttention(dim, heads, dtype=dtype, attn_impl=attn_impl)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim, dtype=dtype, attn_impl=attn_impl)
        self.norm3 = LayerNorm32(dim)
        self.ff_geglu = _GEGLUProj(dim, 4 * dim, dtype)
        self.ff_out = _linear(4 * dim, dim, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        if context.shape[0] != x.shape[0]:
            # conditioning dedup: expand group-major where context enters
            g = _tile_count("the context", context.shape[0], "the activations", x.shape[0])
            x = x.repeat(g, 1, 1)
        x = x + self.attn2(self.norm2(x), context)
        proj = self.ff_geglu.proj
        if self.ffn_impl == "einsum":
            # JAX's plain lowering: fp32 LN, the GEGLU projection and the
            # out-projection in the weights' dtype, exact (erf) gelu
            h = proj(self.norm3(x).to(proj.weight.dtype))
            value, gate = h.chunk(2, dim=-1)
            return x + self.ff_out(value * F.gelu(gate))
        return geglu_ffn_block(
            x.contiguous(), self.norm3.weight, self.norm3.bias, proj.weight,
            proj.bias, self.ff_out.weight, self.ff_out.bias, eps=self.norm3.eps,
            approximate=False)


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> ``depth`` transformer blocks (``block_0``
    ...) -> proj_out, residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, dtype=torch.bfloat16,
                 attn_impl: str = "flash_eod", ffn_impl: str = "fused", depth: int = 1):
        super().__init__()
        self.depth = depth
        # diffusers Transformer2DModel input GroupNorm uses eps 1e-6
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = _linear(channels, channels, dtype)
        for k in range(depth):
            self.add_module(f"block_{k}", TransformerBlock(channels, heads, context_dim, dtype,
                                                           attn_impl, ffn_impl))
        self.proj_out = _linear(channels, channels, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        z = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for k in range(self.depth):
            z = getattr(self, f"block_{k}")(z, context)
        z = self.proj_out(z)
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
        h = self.conv1(self.norm1(x, silu=True))
        te = self.time_emb_proj(F.silu(temb))
        if te.shape[0] != h.shape[0]:
            # conditioning dedup past the first cross-attention: the time
            # embedding (no added embedding) is the groups' shared one
            g = _tile_count("the activations", h.shape[0], "the time embedding", te.shape[0])
            te = te.repeat(g, 1)
        h = self.conv2(self.norm2(h, shift=te, silu=True))
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
        self.register_buffer("phase_taps", _PHASE_TAPS.to(self.weight.device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.out_channels
        b, _, h, w = x.shape
        ms = self.phase_taps
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
        ctx_dim = cfg.cross_attention_dim
        self.time_embed_1 = _linear(ch0, temb_ch, dtype)
        self.register_buffer("temb_freqs",
                             sd_timestep_freqs(ch0).to(self.time_embed_1.weight.device),
                             persistent=False)
        self.time_embed_2 = _linear(temb_ch, temb_ch, dtype)
        if cfg.added_embedding:
            self.add_embed_1 = _linear(cfg.projection_class_embeddings_input_dim, temb_ch, dtype)
            self.add_embed_2 = _linear(temb_ch, temb_ch, dtype)
            self.register_buffer(
                "add_time_freqs",
                sd_timestep_freqs(cfg.addition_time_embed_dim).to(self.add_embed_1.weight.device),
                persistent=False)

        def transformer(ch, i):
            return SpatialTransformer(ch, cfg.level("attention_head_dim", i), ctx_dim, dtype,
                                      cfg.attn_impl, cfg.ffn_impl,
                                      cfg.level("transformer_layers_per_block", i))

        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, dtype=dtype)
        n = len(cfg.block_out_channels)
        ch, skips = ch0, [ch0]
        for i, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(ch, out_ch, temb_ch, dtype))
                ch = out_ch
                if block_type == "CrossAttnDownBlock2D":
                    self.add_module(f"down_{i}_attn_{j}", transformer(ch, i))
                skips.append(ch)
            if i != n - 1:
                # symmetric stride-2 padding, as torch's Downsample2D
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock2D(ch, ch, temb_ch, dtype)
        self.mid_attn = transformer(ch, n - 1)
        self.mid_res_1 = ResnetBlock2D(ch, ch, temb_ch, dtype)
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = cfg.block_out_channels[n - 1 - i]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock2D(ch + skips.pop(), out_ch, temb_ch, dtype))
                ch = out_ch
                if block_type == "CrossAttnUpBlock2D":
                    self.add_module(f"up_{i}_attn_{j}", transformer(ch, n - 1 - i))
            if i != n - 1:
                self.add_module(f"up_{i}_upsample", SubpixelUpsample(ch, ch))
        self.norm_out = GroupNorm32(ch)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1, dtype=dtype)

    def add_embedding(self, text_embeds: torch.Tensor, time_ids: torch.Tensor) -> torch.Tensor:
        """SDXL's ``text_time`` embedding (rows, 4 * C0) in the compute
        dtype: the pooled text (rows, P) and the size ids, (6,) shared by
        every row or (rows, 6), each id through ``Timesteps(256)``."""
        dt, rows = self.dtype, text_embeds.shape[0]
        ids = time_ids.float().reshape(-1, time_ids.shape[-1])
        te = sd_timestep_embedding(ids.reshape(-1), self.config.addition_time_embed_dim,
                                   freqs=self.add_time_freqs).reshape(ids.shape[0], -1)
        h = torch.cat([text_embeds.to(dt), te.to(dt).expand(rows, -1)], dim=-1)
        return self.add_embed_2(F.silu(self.add_embed_1(h)))

    def forward(self, x: torch.Tensor, t, context: torch.Tensor,
                text_embeds: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``text_embeds`` (rows of ``context``, P) and ``time_ids`` (6,)
        or (rows, 6): SDXL's added conditioning, given exactly when the
        config has it."""
        cfg, dt = self.config, self.dtype
        if cfg.added_embedding != (text_embeds is not None and time_ids is not None):
            raise ValueError("SDUNet: text_embeds and time_ids are given exactly when the "
                             "config has the added embedding (addition_embed_type "
                             f"{cfg.addition_embed_type!r})")
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        temb = sd_timestep_embedding(t.reshape(-1).expand(x.shape[0]),
                                     cfg.block_out_channels[0], freqs=self.temb_freqs)
        temb = self.time_embed_2(F.silu(self.time_embed_1(temb.to(dt))))
        context = context.to(dt)
        h = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(h)
        if cfg.added_embedding:
            # the time embedding differs per conditioning from here on: the
            # shared latents are tiled after conv_in, the last shared op
            if text_embeds.shape[0] != context.shape[0]:
                raise ValueError(f"SDUNet: text_embeds has {text_embeds.shape[0]} rows, the "
                                 f"context {context.shape[0]}")
            g = _tile_count("the context", context.shape[0], "the latents", h.shape[0])
            temb = temb.repeat(g, 1) + self.add_embedding(text_embeds, time_ids)
            h = h.permute(0, 2, 3, 1).repeat(g, 1, 1, 1).permute(0, 3, 1, 2)  # channels_last
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
        h = self.conv_out(self.norm_out(h, silu=True))
        return h.permute(0, 2, 3, 1).float()

