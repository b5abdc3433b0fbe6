"""Plain reference of SDXL base 1.0 under the SuperDiff OR composition: the
two text towers (CLIP ViT-L/14 and OpenCLIP ViT-bigG/14), the conditional
UNet with the ``text_time`` added embedding, the VAE decoder and the
sigma-space OR sampler, written out in plain PyTorch from the published
configuration (stabilityai/stable-diffusion-xl-base-1.0: ``unet``,
``text_encoder``, ``text_encoder_2``, ``vae`` and ``model_index.json``'s
``force_zeros_for_empty_prompt``) and the SuperDiff OR step.

It imports nothing of the program under test. It loads the SD-1.x
reference beside it (``sd-v1-4.py``) and takes from there what computes
SDXL's mathematics unchanged: the norms, the attention, the resnet, the
cross-attention layer, the VAE decoder, the timestep embedding, the crc32
tokenizer, the sigma grid and the decode. Products run through
``_precision.q``; norms, softmaxes and the sampler stay float32. Parameter
names follow the layout the benchmark draws its weights in.

The context is the two towers' penultimate hidden states (no final
LayerNorm) concatenated, 768 + 1280 wide; the pooled embedding is bigG's
final LayerNorm at the first end token through ``text_projection``; the
empty prompt's context and pooled embedding are zeros; the six size ids
each go through a 256-wide sinusoid (cos first). The UNet runs every
conditioning's copy of the latents whole (no rows shared).

Departures, each exact in real arithmetic: each nearest 2x upsample and 3x3
convolution runs as four 2x2 convolutions, one per output phase; attention
runs in blocks of (batch, head) pairs so its logits fit; every tower runs
all its layers, whichever it reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.harness.spec import HERE, load_module
from benchmark.reference._ops import conv, linear, upsample_conv
from benchmark.reference._precision import q

v1 = load_module(f"{HERE}/reference/sd-v1-4.py", "benchmark.reference.sd_v1_4")
Norm, Attn, Resnet, VAEDecoder = v1.Norm, v1.Attn, v1.Resnet, v1.VAEDecoder
sigma_grid, noise_path, decode, served_dtype = (v1.sigma_grid, v1.noise_path, v1.decode,
                                                v1.served_dtype)


# ------------------------------------------------------------------- text

def eos_id(vocab_size: int) -> int:
    return 49407 if 49407 < vocab_size else 2


def tokenize(prompts, vocab_size: int, max_length: int, pad: int) -> np.ndarray:
    """The crc32 stand-in of the SD-1.x reference, padded after the end
    token with ``pad`` (SDXL's ``tokenizer_2`` pads with "!", id 0)."""
    ids = v1.tokenize(prompts, vocab_size, max_length)
    eos = eos_id(vocab_size)
    for row in ids:
        end = int(np.argmax(row == eos))
        row[end + 1:] = pad
    return ids


class CLIPText(nn.Module):
    """token ids (B, 77) -> (the hidden states before the last layer (B, 77,
    W), the pooled embedding (B, P) or None), float32."""

    def __init__(self, c: dict):
        super().__init__()
        w = c["hidden_size"]
        self.layers_n, self.heads, self.eos = (c["num_hidden_layers"], c["num_attention_heads"],
                                               eos_id(c["vocab_size"]))
        self.act = {"quick_gelu": lambda h: h * torch.sigmoid(1.702 * h),
                    "gelu": F.gelu}[c["hidden_act"]]
        self.token_embedding = nn.Embedding(c["vocab_size"], w)
        self.position_embedding = nn.Parameter(torch.zeros(c["max_position_embeddings"], w))
        for i in range(self.layers_n):
            self.add_module(f"layer_{i}", v1.CLIPLayer(w, self.heads))
        self.final_layer_norm = Norm(w)
        projected = c["architectures"][0].endswith("WithProjection")
        self.text_projection = nn.Linear(w, c["projection_dim"], bias=False) if projected else None

    def layer(self, lay, x):
        """One pre-norm layer with causal self-attention and this tower's
        activation."""
        a = lay.self_attn
        h = lay.layer_norm1(x)
        b, l, c = h.shape
        d = c // self.heads
        qh, kh, vh = (linear(p, h).reshape(b, l, self.heads, d).transpose(1, 2)
                      for p in (a.q_proj, a.k_proj, a.v_proj))
        logits = torch.einsum("bhqd,bhkd->bhqk", q(qh), q(kh)) * d**-0.5
        logits = logits + torch.triu(torch.full((l, l), -1e9, device=x.device), diagonal=1)
        o = torch.einsum("bhqk,bhkd->bhqd", q(torch.softmax(logits, -1)), q(vh))
        x = x + linear(a.out_proj, o.transpose(1, 2).reshape(b, l, c))
        return x + linear(lay.fc2, self.act(linear(lay.fc1, lay.layer_norm2(x))))

    def forward(self, ids):
        pos = self.position_embedding.float()[None, :ids.shape[1]]
        x = self.token_embedding.weight.float()[ids] + pos
        states = [x]
        for i in range(self.layers_n):
            states.append(self.layer(getattr(self, f"layer_{i}"), states[-1]))
        if self.text_projection is None:
            return states[-2], None
        first_eos = (ids == self.eos).int().argmax(1)
        pooled = self.final_layer_norm(states[-1][torch.arange(ids.shape[0]), first_eos])
        return states[-2], linear(self.text_projection, pooled)


# ------------------------------------------------------------------- UNet

class Transformer(nn.Module):
    """GroupNorm, proj_in, ``depth`` x [self-attn, cross-attn, GEGLU FFN],
    proj_out, residual."""

    def __init__(self, c, heads, ctx_dim, depth):
        super().__init__()
        self.depth = depth
        self.norm = Norm(c, 32, 1e-6)
        self.proj_in = nn.Linear(c, c)
        for k in range(depth):
            blk = nn.Module()
            blk.norm1, blk.attn1 = Norm(c), Attn(c, heads)
            blk.norm2, blk.attn2 = Norm(c), Attn(c, heads, ctx_dim)
            blk.norm3 = Norm(c)
            blk.ff_geglu = nn.Module()
            blk.ff_geglu.proj = nn.Linear(c, 8 * c)
            blk.ff_out = nn.Linear(4 * c, c)
            self.add_module(f"block_{k}", blk)
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        z = linear(self.proj_in, self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        for k in range(self.depth):
            blk = getattr(self, f"block_{k}")
            z = z + blk.attn1(blk.norm1(z))
            z = z + blk.attn2(blk.norm2(z), ctx)
            value, gate = linear(blk.ff_geglu.proj, blk.norm3(z)).chunk(2, dim=-1)
            z = z + linear(blk.ff_out, value * F.gelu(gate))
        z = linear(self.proj_out, z).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return z + x


class UNet(nn.Module):
    """(latents (N, h, w, 4) NHWC, t, contexts (N, 77, 2048), pooled text
    (N, 1280), size ids (6,)) -> (N, h, w, 4): one row per conditioning."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        chs, lpb = c["block_out_channels"], c["layers_per_block"]
        heads, depth = c["attention_head_dim"], c["transformer_layers_per_block"]
        ctx_dim = c["cross_attention_dim"]
        ch0 = chs[0]
        temb = 4 * ch0
        self.time_embed_1 = nn.Linear(ch0, temb)
        self.time_embed_2 = nn.Linear(temb, temb)
        self.add_embed_1 = nn.Linear(c["projection_class_embeddings_input_dim"], temb)
        self.add_embed_2 = nn.Linear(temb, temb)
        self.conv_in = nn.Conv2d(c["in_channels"], ch0, 3, padding=1)
        n, ch, skips = len(chs), ch0, [ch0]
        for i, kind in enumerate(c["down_block_types"]):
            for j in range(lpb):
                self.add_module(f"down_{i}_res_{j}", Resnet(ch, chs[i], temb))
                ch = chs[i]
                if kind.startswith("CrossAttn"):
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer(ch, heads[i], ctx_dim, depth[i]))
                skips.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
        self.mid_res_0 = Resnet(ch, ch, temb)
        self.mid_attn = Transformer(ch, heads[-1], ctx_dim, depth[-1])
        self.mid_res_1 = Resnet(ch, ch, temb)
        for i, kind in enumerate(c["up_block_types"]):
            level = n - 1 - i
            for j in range(lpb + 1):
                self.add_module(f"up_{i}_res_{j}", Resnet(ch + skips.pop(), chs[level], temb))
                ch = chs[level]
                if kind.startswith("CrossAttn"):
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer(ch, heads[level], ctx_dim, depth[level]))
            if i != n - 1:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(ch, ch, 3, padding=1))
        self.norm_out = Norm(ch, 32)
        self.conv_out = nn.Conv2d(ch, c["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx, text_embeds, time_ids):
        c = self.c
        chs, lpb, n = c["block_out_channels"], c["layers_per_block"], len(c["block_out_channels"])
        rows = x.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(rows)
        temb = linear(self.time_embed_2, F.silu(linear(self.time_embed_1,
                                                       v1.timestep_embedding(t, chs[0]))))
        ids = time_ids.float().reshape(-1)
        sizes = v1.timestep_embedding(ids, c["addition_time_embed_dim"]).reshape(1, -1)
        added = torch.cat([text_embeds.float(), sizes.expand(rows, -1)], dim=-1)
        temb = temb + linear(self.add_embed_2, F.silu(linear(self.add_embed_1, added)))
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
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, hs.pop()], dim=1), temb)
                if kind.startswith("CrossAttn"):
                    h = getattr(self, f"up_{i}_attn_{j}")(h, ctx)
            if i != n - 1:
                h = upsample_conv(getattr(self, f"up_{i}_upsample"), h)
        h = conv(self.conv_out, F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 1)


# ------------------------------------------------------------ the stack

PARTS = ("unet", "text", "text_2", "vae")


def build(config: dict, device="cpu") -> dict:
    """The four modules of ``config`` (float32 parameters) on ``device``;
    ``"meta"`` gives their names and shapes for nothing."""
    with torch.device(device):
        return {"unet": UNet(config["unet"]), "text": CLIPText(config["text_encoder"]),
                "text_2": CLIPText(config["text_encoder_2"]), "vae": VAEDecoder(config["vae"])}


def encode(m: dict, config: dict, prompts, device):
    """(the context (B, 77, 2048), the pooled embedding (B, 1280)) of
    ``prompts``: the towers' penultimate states side by side, bigG's pooled
    output."""
    out = []
    for part, key, pad in (("text", "text_encoder", None), ("text_2", "text_encoder_2", 0)):
        c = config[key]
        ids = tokenize(prompts, c["vocab_size"], c["max_position_embeddings"],
                       eos_id(c["vocab_size"]) if pad is None else pad)
        out.append(m[part](torch.as_tensor(ids, device=device)))
    return torch.cat([out[0][0], out[1][0]], dim=-1), out[1][1]


def conditioning(m: dict, config: dict, obj: str, bg: str, b: int, device):
    """The contexts and pooled embeddings of obj, bg and the empty prompt,
    ``b`` rows each, group-major: zeros for the empty prompt where the
    configuration forces them."""
    zeros = config["force_zeros_for_empty_prompt"]
    ctx, pooled = encode(m, config, [obj] * b + [bg] * b + ([] if zeros else [""] * b), device)
    if zeros:
        ctx = torch.cat([ctx, torch.zeros_like(ctx[:b])])
        pooled = torch.cat([pooled, torch.zeros_like(pooled[:b])])
    return ctx, pooled


@torch.no_grad()
def sample_or(m: dict, config: dict, obj: str, bg: str, x_T: torch.Tensor, zs: torch.Tensor,
              method: dict):
    """The OR composition of prompts ``obj`` and ``bg`` from the unit
    normals ``x_T`` (B, h, w, 4) and ``zs`` (steps, B, h, w, 4), as the
    SD-1.x reference's ``sample_or``, the UNet run on three copies of the
    latents with SDXL's conditioning and ``method["size_ids"]``. Returns
    (latents (B, h, w, 4), kappa (steps, B), ll (steps, B, 2), margin (B,)),
    float32."""
    dev, b = x_T.device, x_T.shape[0]
    steps = zs.shape[0]
    g, temp, logp = method["guidance_scale"], method["temperature"], method["logp"]
    ctx, pooled = conditioning(m, config, obj, bg, b, dev)
    size_ids = torch.tensor(method["size_ids"], dtype=torch.float32, device=dev)
    ts, sig, init = sigma_grid(steps)
    ts, sig = torch.tensor(ts, dtype=torch.float32), torch.tensor(sig, dtype=torch.float32)
    x = x_T.float() * init
    ll = torch.ones((b, 2), dtype=torch.float32, device=dev)
    margin = torch.full((b,), float("inf"), device=dev)
    size = torch.zeros((b,), device=dev)
    kappas, lls = [], []
    for i in range(steps):
        sigma, dsigma = sig[i].to(dev), (sig[i + 1] - sig[i]).to(dev)
        x_in = (x / torch.sqrt(sigma**2 + 1.0)).repeat(3, 1, 1, 1)
        v = m["unet"](x_in, ts[i].to(dev), ctx, pooled, size_ids).reshape(3, b, -1)
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
