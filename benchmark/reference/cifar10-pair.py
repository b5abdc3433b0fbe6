"""Plain reference of the CIFAR-10 joint OR sampler: two DDPM-style score
UNets (the reference repository's ``cifar/models``: ``ScoreNet`` of
``cifar/configs/sm/cifar/vpsde.py``) under the VP-SDE reverse trajectory,
mixed by OR over their Itô log-densities (``cifar/dynamics.py:115-136``).

It imports nothing of the program under test. Products run through
``_precision.q``; norms, softmaxes and the sampler stay float32. Parameter
names follow the layout the benchmark draws its weights in, so one state
dict loads into the program and into this reference alike. The nets run in
evaluation mode (no dropout), as a sampler runs them. Each nearest 2x
upsample and 3x3 convolution runs as four 2x2 convolutions, one per output
phase (the least work; exact in real arithmetic).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import _ops
from benchmark.reference._ops import linear, upsample_conv
from benchmark.reference._precision import q


def conv(layer: nn.Conv2d, x, stride=1, pad=(1, 1, 1, 1)):
    return _ops.conv(layer, x, stride, pad)


class GN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.groups = min(32, c)
        while c % self.groups:
            self.groups -= 1

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight.float(), self.bias.float(), 1e-6)


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb):
        super().__init__()
        self.GroupNorm32_0 = GN(cin)
        self.Conv_0 = nn.Conv2d(cin, cout, 3)
        self.Dense_0 = nn.Linear(temb, cout)
        self.GroupNorm32_1 = GN(cout)
        self.Conv_1 = nn.Conv2d(cout, cout, 3)
        self.Dense_1 = nn.Linear(cin, cout) if cin != cout else None

    def forward(self, x, temb):
        h = conv(self.Conv_0, F.silu(self.GroupNorm32_0(x)))
        h = h + linear(self.Dense_0, F.silu(temb))[:, :, None, None]
        h = conv(self.Conv_1, F.silu(self.GroupNorm32_1(h)))
        if self.Dense_1 is not None:
            x = linear(self.Dense_1, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + h


class Attn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.GroupNorm32_0 = GN(c)
        for i in range(4):
            self.add_module(f"Dense_{i}", nn.Linear(c, c))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm32_0(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        qx, kx, vx = (linear(getattr(self, f"Dense_{i}"), h) for i in range(3))
        w = torch.softmax(torch.einsum("bqc,bkc->bqk", q(qx), q(kx)) * c**-0.5, dim=-1)
        o = linear(self.Dense_3, torch.einsum("bqk,bkc->bqc", q(w), q(vx)))
        return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class ScoreNet(nn.Module):
    """(t (B,), x (B, 32, 32, 3) NHWC) -> the sigma-scaled score, NHWC."""

    def __init__(self, c: dict):
        super().__init__()
        nf, mult, nres = c["nf"], c["ch_mult"], c["num_res_blocks"]
        self.c, self.counts, temb = c, {}, 4 * nf
        self.Dense_0 = nn.Linear(nf, temb)
        self.Dense_1 = nn.Linear(temb, temb)
        self.Conv_0 = nn.Conv2d(c["num_channels"], nf, 3)
        ch, res, skips, self.plan = nf, c["image_size"], [nf], []
        for level, m in enumerate(mult):
            for _ in range(nres):
                self.plan.append(("res", self.child("ResnetBlock", Resnet(ch, nf * m, temb))))
                ch = nf * m
                if res in c["attn_resolutions"]:
                    self.plan.append(("attn", self.child("AttnBlock", Attn(ch))))
                self.plan.append(("push", None))
                skips.append(ch)
            if level != len(mult) - 1:
                self.plan.append(("down", self.child("Downsample", nn.Module())))
                getattr(self, self.plan[-1][1]).Conv_0 = nn.Conv2d(ch, ch, 3)
                self.plan.append(("push", None))
                skips.append(ch)
                res //= 2
        self.plan += [("res", self.child("ResnetBlock", Resnet(ch, ch, temb))),
                      ("attn", self.child("AttnBlock", Attn(ch))),
                      ("res", self.child("ResnetBlock", Resnet(ch, ch, temb)))]
        for level in reversed(range(len(mult))):
            for _ in range(nres + 1):
                self.plan.append(("pop", None))
                self.plan.append(("res", self.child("ResnetBlock",
                                                    Resnet(ch + skips.pop(), nf * mult[level], temb))))
                ch = nf * mult[level]
            if res in c["attn_resolutions"]:
                self.plan.append(("attn", self.child("AttnBlock", Attn(ch))))
            if level != 0:
                self.plan.append(("up", self.child("Upsample", nn.Module())))
                getattr(self, self.plan[-1][1]).Conv_0 = nn.Conv2d(ch, ch, 3)
                res *= 2
        self.GroupNorm32_0 = GN(ch)
        self.Conv_1 = nn.Conv2d(ch, c["num_channels"], 3)

    def child(self, kind, module):
        i = self.counts.get(kind, 0)
        self.counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return f"{kind}_{i}"

    def forward(self, t, x):
        nf = self.c["nf"]
        half = nf // 2
        freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32,
                                                             device=x.device) / (half - 1))
        args = t.float().reshape(-1, 1) * freqs[None]
        temb = linear(self.Dense_0, torch.cat([torch.sin(args), torch.cos(args)], -1))
        temb = linear(self.Dense_1, F.silu(temb))
        h = conv(self.Conv_0, x.float().permute(0, 3, 1, 2))
        hs = [h]
        for kind, name in self.plan:
            mod = getattr(self, name) if name else None
            if kind == "res":
                h = mod(h, temb)
            elif kind == "attn":
                h = mod(h)
            elif kind == "push":
                hs.append(h)
            elif kind == "down":  # stride 2, Flax's SAME padding: 0 before, 1 after
                h = conv(mod.Conv_0, h, stride=2, pad=(0, 1, 0, 1))
            elif kind == "pop":
                h = torch.cat([h, hs.pop()], dim=1)
            elif kind == "up":
                h = upsample_conv(mod.Conv_0, h)
        assert not hs
        h = conv(self.Conv_1, F.silu(self.GroupNorm32_0(h)))
        return h.permute(0, 2, 3, 1)


def build(config: dict, device="cpu") -> dict:
    """One ``ScoreNet`` per model of ``config`` (float32 parameters) on
    ``device``; ``"meta"`` gives their names and shapes for nothing."""
    with torch.device(device):
        return {f"model_{i}": ScoreNet(config["model"]) for i in range(config["n_models"])}


def served_dtype(part: str, name: str) -> torch.dtype:
    """The program keeps these nets' parameters in float32 and casts them
    to the compute dtype at each use."""
    return torch.float32


def step_table(sampler: dict, device) -> torch.Tensor:
    """(steps, 5) float32 rows (t, dlog_alpha/dt, beta, sigma, dt) of the
    VP-SDE with sigma(t) = t (``cifar/dynamics.py:15-27``)."""
    n, b0, b1 = sampler["n_steps"], sampler["beta_0"], sampler["beta_1"]
    dt = torch.tensor(sampler["t_1"] / n, dtype=torch.float32)
    t = sampler["t_1"] - torch.arange(n, dtype=torch.float32) * dt
    da = -0.5 * b0 - 0.5 * t * (b1 - b0)
    beta = 1.0 + 0.5 * t * b0 + 0.5 * t**2 * (b1 - b0)
    return torch.stack([t, da, beta, t, dt.expand(n)], -1).to(device)


@torch.no_grad()
def sample_or(m: dict, config: dict, x1: torch.Tensor, zs: torch.Tensor):
    """The joint reverse trajectory under OR from the unit normals ``x1``
    (B, 32, 32, 3) and ``zs`` (steps, B, 32, 32, 3). Returns (x0, logq (B,
    N), margin (B,)), float32, logq max-renormalised each step. ``margin``
    is how far each row's OR choice stands from a tie: the least, over the
    steps whose log-densities set a later choice, of the gap between the
    two largest over the summed size of every increment so far. Where it
    is small the choice turns on rounding."""
    s = config["sampler"]
    nets = [m[f"model_{i}"] for i in range(config["n_models"])]
    b = x1.shape[0]
    x = x1.float().reshape(b, -1)
    logq = torch.zeros((b, len(nets)), dtype=torch.float32, device=x.device)
    margin = torch.full((b,), float("inf"), device=x.device)
    size = torch.zeros((b,), device=x.device)
    for i, (t, da, beta, sigma, dt) in enumerate(step_table(s, x.device)):
        img = x.reshape(x1.shape)
        scores = torch.stack([net(t.expand(b), img).reshape(b, -1) for net in nets])
        w = torch.softmax(s["or_temperature"] * logq, dim=-1)
        mixed = torch.einsum("bn,nbd->bd", w, scores)
        dx = -dt * (da * x - 2.0 * beta * mixed) + torch.sqrt(2.0 * sigma * beta * dt) * \
            zs[i].reshape(b, -1).float()
        v = da * x[None] - 2.0 * beta * scores
        f_next = da * (x + dx)[None]
        dlogq = ((f_next - v) * (dt * v + 2.0 * dx[None] + dt * f_next)).sum(-1).T / (
            4.0 * sigma * beta)
        logq = logq + dlogq
        size = size + dlogq.abs().sum(-1)
        if i < s["n_steps"] - 1:
            top = logq.topk(2, dim=-1).values
            margin = torch.minimum(margin, (top[:, 0] - top[:, 1]) / size)
        logq = logq - logq.max(dim=-1, keepdim=True).values
        x = x + dx
    return x.reshape(x1.shape), logq, margin


def noise_path(config: dict, x1: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """Where the trajectory ends when every score is 0: the drift of the
    VP-SDE and the injected noise alone."""
    b = x1.shape[0]
    x = x1.float().reshape(b, -1)
    for i, (t, da, beta, sigma, dt) in enumerate(step_table(config["sampler"], x.device)):
        x = x - dt * da * x + torch.sqrt(2.0 * sigma * beta * dt) * zs[i].reshape(b, -1).float()
    return x.reshape(x1.shape)
