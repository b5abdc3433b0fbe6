"""Plain reference of the SD-1.x OR composition: the CLIP text encoder, the
conditional UNet, the VAE decoder and the sigma-space OR sampler, written
out in plain PyTorch from the published architecture
(CompVis/stable-diffusion-v1-4: ``unet/config.json``, CLIP ViT-L/14's text
tower, the AutoencoderKL decoder) and the SuperDiff OR step.

It imports nothing of the program under test. Products run through
``_precision.q`` (float32, or an emulated lower precision for the control);
norms, softmaxes and the sampler stay float32. Parameter names follow the
layout the benchmark draws its weights in, so one state dict loads into the
program and into this reference alike.

Departures, each exact in real arithmetic: the UNet shares the latents of
the three conditionings until the first cross-attention (the least work);
each nearest 2x upsample and 3x3 convolution runs as four 2x2
convolutions, one per output phase (the least work);
attention runs in blocks of (batch, head) pairs so its logits fit.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference._ops import conv, linear, upsample_conv
from benchmark.reference._precision import q

_ATTN_BLOCK_BYTES = 2 << 30


# ----------------------------------------------------------------- layers

class Norm(nn.Module):
    """Group norm (``groups`` > 0, on (B, C, ...)) or layer norm (``groups``
    0, on the last axis), float32."""

    def __init__(self, channels: int, groups: int = 0, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if self.groups:
            return F.group_norm(x.float(), self.groups, self.weight.float(), self.bias.float(),
                                self.eps)
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
                            self.eps)


def attention(qx, kx, vx, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, L, C) inputs split into heads, in
    blocks of (batch, head) pairs; returns (B, Lq, C) float32."""
    b, lq, c = qx.shape
    lk, d = kx.shape[1], c // heads
    split = lambda a, l: a.reshape(b, l, heads, d).transpose(1, 2).reshape(b * heads, l, d)
    qh, kh, vh = split(qx, lq), split(kx, lk), split(vx, lk)
    out = torch.empty_like(qh)
    step = max(1, _ATTN_BLOCK_BYTES // (4 * lq * lk))
    for i in range(0, b * heads, step):
        s = slice(i, i + step)
        logits = torch.einsum("bqd,bkd->bqk", q(qh[s]), q(kh[s])) * d**-0.5
        out[s] = torch.einsum("bqk,bkd->bqd", q(torch.softmax(logits, dim=-1)), q(vh[s]))
    return out.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, c)


# ------------------------------------------------------------------- CLIP

def tokenize(prompts, vocab_size: int = 49408, max_length: int = 77) -> np.ndarray:
    """CLIP's special ids around one crc32 id per lower-cased word, padded
    with the end id: the deterministic stand-in tokenizer of a run without
    a vocabulary file."""
    bos = 49406 if 49406 < vocab_size else 1
    eos = 49407 if 49407 < vocab_size else 2
    ids = np.full((len(prompts), max_length), eos, dtype=np.int64)
    ids[:, 0] = bos
    for i, p in enumerate(prompts):
        toks = [3 + (zlib.crc32(w.encode()) % (vocab_size - 4))
                for w in p.lower().split()][: max_length - 2]
        ids[i, 1:1 + len(toks)] = toks
        ids[i, 1 + len(toks)] = eos
    return ids


class CLIPLayer(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = Norm(c)
        self.self_attn = nn.Module()
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.self_attn.add_module(n, nn.Linear(c, c))
        self.layer_norm2 = Norm(c)
        self.fc1 = nn.Linear(c, 4 * c)
        self.fc2 = nn.Linear(4 * c, c)

    def forward(self, x):
        a = self.self_attn
        h = self.layer_norm1(x)
        b, l, c = h.shape
        d = c // self.heads
        qh, kh, vh = (linear(p, h).reshape(b, l, self.heads, d).transpose(1, 2)
                      for p in (a.q_proj, a.k_proj, a.v_proj))
        logits = torch.einsum("bhqd,bhkd->bhqk", q(qh), q(kh)) * d**-0.5
        logits = logits + torch.triu(torch.full((l, l), -1e9, device=x.device), diagonal=1)
        o = torch.einsum("bhqk,bhkd->bhqd", q(torch.softmax(logits, -1)), q(vh))
        x = x + linear(a.out_proj, o.transpose(1, 2).reshape(b, l, c))
        h = linear(self.fc1, self.layer_norm2(x))
        return x + linear(self.fc2, h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    """token ids (B, 77) -> last hidden states (B, 77, 768) float32."""

    def __init__(self, c: dict):
        super().__init__()
        w = c["hidden_size"]
        self.layers_n = c["num_hidden_layers"]
        self.token_embedding = nn.Embedding(c["vocab_size"], w)
        self.position_embedding = nn.Parameter(torch.zeros(c["max_position_embeddings"], w))
        for i in range(self.layers_n):
            self.add_module(f"layer_{i}", CLIPLayer(w, c["num_attention_heads"]))
        self.final_layer_norm = Norm(w)

    def forward(self, ids):
        x = self.token_embedding.weight.float()[ids] + self.position_embedding.float()[None,
                                                                                       :ids.shape[1]]
        for i in range(self.layers_n):
            x = getattr(self, f"layer_{i}")(x)
        return self.final_layer_norm(x)


# ------------------------------------------------------------------- UNet

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusers' ``Timesteps`` (flip_sin_to_cos, shift 0): cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float().reshape(-1, 1) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def tile(x: torch.Tensor, batch: int) -> torch.Tensor:
    """x repeated group-major to ``batch`` rows (conditioning groups)."""
    return x if x.shape[0] == batch else x.repeat(batch // x.shape[0], *([1] * (x.ndim - 1)))


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb_ch, groups=32):
        super().__init__()
        self.norm1 = Norm(cin, groups)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = Norm(cout, groups)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = conv(self.conv1, F.silu(self.norm1(x)))
        te = tile(linear(self.time_emb_proj, F.silu(temb)), h.shape[0])
        h = conv(self.conv2, F.silu(self.norm2(h + te[:, :, None, None])))
        if self.conv_shortcut is not None:
            x = conv(self.conv_shortcut, x)
        return x + h


class Attn(nn.Module):
    def __init__(self, c, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(ctx_dim or c, c, bias=False)
        self.to_v = nn.Linear(ctx_dim or c, c, bias=False)
        self.to_out = nn.Linear(c, c)

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        o = attention(linear(self.to_q, x), linear(self.to_k, ctx), linear(self.to_v, ctx),
                      self.heads)
        return linear(self.to_out, o)


class Transformer(nn.Module):
    """GroupNorm, proj_in, [self-attn, cross-attn, GEGLU FFN], proj_out."""

    def __init__(self, c, heads, ctx_dim):
        super().__init__()
        self.norm = Norm(c, 32, 1e-6)
        self.proj_in = nn.Linear(c, c)
        blk = self.block_0 = nn.Module()
        blk.norm1, blk.attn1 = Norm(c), Attn(c, heads)
        blk.norm2, blk.attn2 = Norm(c), Attn(c, heads, ctx_dim)
        blk.norm3 = Norm(c)
        blk.ff_geglu = nn.Module()
        blk.ff_geglu.proj = nn.Linear(c, 8 * c)
        blk.ff_out = nn.Linear(4 * c, c)
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        blk = self.block_0
        z = linear(self.proj_in, self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        z = z + blk.attn1(blk.norm1(z))
        z = tile(z, ctx.shape[0])
        z = z + blk.attn2(blk.norm2(z), ctx)
        value, gate = linear(blk.ff_geglu.proj, blk.norm3(z)).chunk(2, dim=-1)
        z = z + linear(blk.ff_out, value * F.gelu(gate))
        z = linear(self.proj_out, z).reshape(-1, hh, ww, c).permute(0, 3, 1, 2)
        return z + tile(x, z.shape[0])


class UNet(nn.Module):
    """(latents (B, h, w, 4) NHWC, t, contexts (gB, 77, 768)) -> (gB, h, w, 4)."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        chs, lpb = c["block_out_channels"], c["layers_per_block"]
        heads, ctx_dim = c["attention_head_dim"], c["cross_attention_dim"]
        ch0 = chs[0]
        temb = 4 * ch0
        self.time_embed_1 = nn.Linear(ch0, temb)
        self.time_embed_2 = nn.Linear(temb, temb)
        self.conv_in = nn.Conv2d(c["in_channels"], ch0, 3, padding=1)
        n, ch, skips = len(chs), ch0, [ch0]
        for i, kind in enumerate(c["down_block_types"]):
            for j in range(lpb):
                self.add_module(f"down_{i}_res_{j}", Resnet(ch, chs[i], temb))
                ch = chs[i]
                if kind.startswith("CrossAttn"):
                    self.add_module(f"down_{i}_attn_{j}", Transformer(ch, heads, ctx_dim))
                skips.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
        self.mid_res_0 = Resnet(ch, ch, temb)
        self.mid_attn = Transformer(ch, heads, ctx_dim)
        self.mid_res_1 = Resnet(ch, ch, temb)
        for i, kind in enumerate(c["up_block_types"]):
            out = chs[n - 1 - i]
            for j in range(lpb + 1):
                self.add_module(f"up_{i}_res_{j}", Resnet(ch + skips.pop(), out, temb))
                ch = out
                if kind.startswith("CrossAttn"):
                    self.add_module(f"up_{i}_attn_{j}", Transformer(ch, heads, ctx_dim))
            if i != n - 1:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(ch, ch, 3, padding=1))
        self.norm_out = Norm(ch, 32)
        self.conv_out = nn.Conv2d(ch, c["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx):
        c = self.c
        chs, lpb, n = c["block_out_channels"], c["layers_per_block"], len(c["block_out_channels"])
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(x.shape[0])
        temb = linear(self.time_embed_2, F.silu(linear(self.time_embed_1,
                                                       timestep_embedding(t, chs[0]))))
        h = conv(self.conv_in, x.float().permute(0, 3, 1, 2))
        hs = [h]
        for i, kind in enumerate(c["down_block_types"]):
            for j in range(lpb):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if kind.startswith("CrossAttn"):
                    h = getattr(self, f"down_{i}_attn_{j}")(h, ctx)
                hs.append(h)
            if i != n - 1:
                h = conv(getattr(self, f"down_{i}_downsample"), h)
                hs.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, temb), ctx), temb)
        for i, kind in enumerate(c["up_block_types"]):
            for j in range(lpb + 1):
                h = torch.cat([h, tile(hs.pop(), h.shape[0])], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if kind.startswith("CrossAttn"):
                    h = getattr(self, f"up_{i}_attn_{j}")(h, ctx)
            if i != n - 1:
                h = upsample_conv(getattr(self, f"up_{i}_upsample"), h)
        h = conv(self.conv_out, F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 1)


# -------------------------------------------------------------------- VAE

class VAEResnet(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = Norm(cin, 32, 1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = Norm(cout, 32, 1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = conv(self.conv2, F.silu(self.norm2(conv(self.conv1, F.silu(self.norm1(x))))))
        return (x if self.shortcut is None else conv(self.shortcut, x)) + h


class VAEAttn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = Norm(c, 32, 1e-6)
        self.q, self.k, self.v, self.proj_out = (nn.Linear(c, c) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        z = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        o = attention(linear(self.q, z), linear(self.k, z), linear(self.v, z), 1)
        return x + linear(self.proj_out, o).reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class VAEDecoder(nn.Module):
    """latents (B, h, w, 4) NHWC -> images (B, 8h, 8w, 3) NHWC in [-1, 1]-ish."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        chs = list(c["block_out_channels"])
        lat, lpb = c["latent_channels"], c["layers_per_block"]
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        self.conv_in = nn.Conv2d(lat, chs[-1], 3, padding=1)
        self.mid_res_0 = VAEResnet(chs[-1], chs[-1])
        self.mid_attn = VAEAttn(chs[-1])
        self.mid_res_1 = VAEResnet(chs[-1], chs[-1])
        ch = chs[-1]
        for i, out in enumerate(reversed(chs)):
            for j in range(lpb + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(ch, out))
                ch = out
            if i != len(chs) - 1:
                self.add_module(f"up_{i}_conv", nn.Conv2d(ch, ch, 3, padding=1))
        self.norm_out = Norm(ch, 32, 1e-6)
        self.conv_out = nn.Conv2d(ch, c["out_channels"], 3, padding=1)

    def forward(self, z):
        n, lpb = len(self.c["block_out_channels"]), self.c["layers_per_block"]
        h = conv(self.conv_in, conv(self.post_quant_conv, z.float().permute(0, 3, 1, 2)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for i in range(n):
            for j in range(lpb + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i != n - 1:
                h = upsample_conv(getattr(self, f"up_{i}_conv"), h)
        return conv(self.conv_out, F.silu(self.norm_out(h))).permute(0, 2, 3, 1)


# ------------------------------------------------------------ the stack

PARTS = ("unet", "text", "vae")


def build(config: dict, device="cpu") -> dict:
    """The three modules of ``config`` (float32 parameters) on ``device``;
    ``"meta"`` gives their names and shapes for nothing."""
    with torch.device(device):
        return {"unet": UNet(config["unet"]), "text": CLIPText(config["text_encoder"]),
                "vae": VAEDecoder(config["vae"])}


def served_dtype(part: str, name: str) -> torch.dtype:
    """The dtype the program serves parameter ``name`` of ``part`` in: the
    products' weights and biases bfloat16; norms, the position embedding
    and the UNet's upsampler taps (kept for their 2x2 phase fold) float32."""
    if "norm" in name or name == "position_embedding" or (part == "unet" and "upsample" in name):
        return torch.float32
    return torch.bfloat16


def sigma_grid(steps: int, train_steps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012):
    """Diffusers' EulerDiscrete grid (scaled-linear betas, linspace
    spacing) in float64: (timesteps (steps,), sigmas (steps + 1,) ending in
    0, the initial noise scale sqrt(sigma_max^2 + 1))."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, train_steps) ** 2
    ac = np.cumprod(1.0 - betas)
    full = np.sqrt((1.0 - ac) / ac)
    ts = np.linspace(0, train_steps - 1, steps)[::-1].copy()
    sig = np.concatenate([np.interp(ts, np.arange(train_steps), full), [0.0]])
    return ts, sig, float(np.sqrt(sig.max() ** 2 + 1.0))


def encode(text: CLIPText, prompts, config: dict, device) -> torch.Tensor:
    c = config["text_encoder"]
    ids = torch.as_tensor(tokenize(prompts, c["vocab_size"], c["max_position_embeddings"]),
                          device=device)
    return text(ids)


@torch.no_grad()
def sample_or(m: dict, config: dict, obj: str, bg: str, x_T: torch.Tensor, zs: torch.Tensor,
              method: dict):
    """The OR composition of prompts ``obj`` and ``bg`` from the unit
    normals ``x_T`` (B, h, w, 4) and ``zs`` (steps, B, h, w, 4): Euler
    steps on the sigma grid with classifier-free guidance, kappa from the
    running log-likelihoods. Returns (latents (B, h, w, 4), kappa (steps,
    B), ll (steps, B, 2), margin (B,)), float32. ``margin`` is how far each
    row's kappa stands from a tie: the least, over the steps whose
    log-likelihoods set a later kappa, of the gap between the two
    conditionings' (with the bias) over the summed size of every increment
    so far. Where it is small, kappa turns on rounding there."""
    dev, b = x_T.device, x_T.shape[0]
    steps = zs.shape[0]
    g, temp, logp = method["guidance_scale"], method["temperature"], method["logp"]
    ctx = torch.cat([encode(m["text"], [p] * b, config, dev) for p in (obj, bg, "")])
    ts, sig, init = sigma_grid(steps)
    ts, sig = torch.tensor(ts, dtype=torch.float32), torch.tensor(sig, dtype=torch.float32)
    x = x_T.float() * init
    ll = torch.ones((b, 2), dtype=torch.float32, device=dev)
    margin = torch.full((b,), float("inf"), device=dev)
    size = torch.zeros((b,), device=dev)
    kappas, lls = [], []
    for i in range(steps):
        sigma, dsigma = sig[i].to(dev), (sig[i + 1] - sig[i]).to(dev)
        v = m["unet"](x / torch.sqrt(sigma**2 + 1.0), ts[i].to(dev), ctx).reshape(3, b, -1)
        v_obj, v_bg, v_unc = v.unbind(0)
        a, c = temp * (ll[:, 0] + logp), temp * ll[:, 1]
        kappa = torch.softmax(torch.stack([a, c], -1), -1)[:, 0]
        vf = v_unc + g * ((v_bg - v_unc) + kappa[:, None] * (v_obj - v_bg))
        dx = 2.0 * dsigma * vf + torch.sqrt(2.0 * dsigma.abs() * sigma) * zs[i].reshape(b, -1)
        dll = -(v[:2] * (dx[None] + dsigma * v[:2])).sum(-1) / sigma
        x = x + dx.reshape(x.shape)
        ll = ll + dll.T
        size = size + dll.abs().sum(0)
        if i < steps - 1:
            margin = torch.minimum(margin, (ll[:, 0] + logp - ll[:, 1]).abs() / size)
        kappas.append(kappa)
        lls.append(ll)
    return x, torch.stack(kappas), torch.stack(lls), margin


def noise_path(x_T: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """Where the sampler ends when every velocity is 0: the initial latents
    and the injected noise alone. What the networks moved is the distance
    from it."""
    steps = zs.shape[0]
    _, sig, init = sigma_grid(steps)
    x = x_T.float() * init
    for i in range(steps):
        x = x + float(np.sqrt(2.0 * abs(sig[i + 1] - sig[i]) * sig[i])) * zs[i].float()
    return x


@torch.no_grad()
def decode(vae: VAEDecoder, latents: torch.Tensor, scaling: float) -> torch.Tensor:
    """Latents -> images in uint8 levels, float32, before rounding:
    clamp(x / 2 + 0.5, 0, 1) * 255."""
    img = vae(latents / scaling)
    return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0) * 255.0
