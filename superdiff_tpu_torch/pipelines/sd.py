"""Stable-Diffusion SuperDiff pipeline: two-prompt composition (port of
``superdiff_tpu/pipelines/sd.py``, method ``or``).

Sigma-space Euler-Maruyama over the EulerDiscrete grid with classifier-free
guidance. Each step runs ONE UNet forward over the obj / bg / uncond
contexts (with conditioning dedup the latents enter once), then the OR
epilogue: on CUDA the ``sd_or_step`` kernel, on the CPU its plain version.
kappa and the running log-likelihoods stay fp32 whatever the compute dtype.

Noise: the sampler takes injected unit normals (the initial latent and the
per-step draws), so tests can hand in the JAX package's threefry draws;
without them it draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.schedules import SigmaGrid
from ..models.sd.clip import CLIPTextConfig, CLIPTextEncoder, Tokenizer
from ..models.from_jax import init_like_flax_
from ..models.sd.unet import SDUNet, SDUNetConfig
from ..models.sd.vae import VAEConfig, VAEDecoder, decode_to_uint8
from ..ops.sd_fused_step import sd_or_step

METHODS = (
    "and", "or", "avg", "and_ode", "avg_ode",
    "sd_ab", "sd_ba", "sd_ab_or", "sd_ba_or", "sd_a", "sd_b",
)
PORTED_METHODS = ("or",)


@dataclasses.dataclass
class SDPipelineConfig:
    num_inference_steps: int = 1000  # reference default
    guidance_scale: float = 7.5
    height: int = 512
    width: int = 512
    temperature: float = 1.0  # OR temperature
    logp: float = 0.0  # OR bias
    # pass the shared latents ONCE per 3-conditioning forward (exact; see
    # the SDUNet docstring)
    cond_dedup: bool = True


@dataclasses.dataclass
class SDModules:
    """Model bundle: UNet + text encoder + VAE decoder on one device."""

    unet: SDUNet
    text: CLIPTextEncoder
    tokenizer: Tokenizer
    vae: VAEDecoder
    vae_scaling: float
    device: torch.device


def build_sd_modules(
    seed: int = 0,
    *,
    unet_config: Optional[SDUNetConfig] = None,
    text_config: Optional[CLIPTextConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    device="cuda",
    dtype=torch.bfloat16,
) -> SDModules:
    """Build the SD stack on ``device`` with random weights drawn from
    ``seed`` with the Flax initialisers' distributions. Load carried weights
    afterwards with ``load_state_dict`` (see ``models/from_jax.py``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    tcfg = text_config or CLIPTextConfig()
    vcfg = vae_config or VAEConfig()
    with torch.device(device):
        unet = SDUNet(unet_config or SDUNetConfig(), dtype=dtype)
        text = CLIPTextEncoder(tcfg, dtype=dtype)
        vae = VAEDecoder(vcfg, dtype=dtype)
    for m in (unet, text, vae):
        init_like_flax_(m, gen).eval().requires_grad_(False)
    return SDModules(unet=unet, text=text, tokenizer=Tokenizer(tcfg), vae=vae,
                     vae_scaling=vcfg.scaling_factor, device=device)


def encode_prompts(mod: SDModules, prompts: list[str]) -> torch.Tensor:
    ids = torch.as_tensor(mod.tokenizer(prompts), dtype=torch.long, device=mod.device)
    return mod.text(ids)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ported: {PORTED_METHODS}); "
            "see ROADMAP.md, queue A")


@torch.no_grad()
def superdiff_sd_sample(
    mod: SDModules,
    method: str,
    ctx_obj: torch.Tensor,
    ctx_bg: torch.Tensor,
    ctx_unc: torch.Tensor,
    cfg: SDPipelineConfig,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, dict]:
    """Run one composed generation; returns (final latents NHWC fp32, traces).

    ``noise``: optional ``(x0, zs)`` unit normals, x0 (B, H/8, W/8, 4) and
    zs (steps, B, H/8, W/8, 4); otherwise both are drawn from ``generator``.
    Traces: per-step ``kappa``, ``ll_obj``, ``ll_bg`` (steps, B) and the
    final log-likelihoods, all fp32.
    """
    _check_method(method)
    dev = ctx_obj.device
    n = cfg.num_inference_steps
    grid = SigmaGrid.euler_discrete(n)
    timesteps, sigmas = grid.as_arrays(device="cpu")
    b = ctx_obj.shape[0]
    shape = (b, cfg.height // 8, cfg.width // 8, 4)
    if noise is None:
        x0 = torch.randn(shape, generator=generator, device=dev)
        zs = torch.randn((n,) + shape, generator=generator, device=dev)
    else:
        x0, zs = (torch.tensor(a, dtype=torch.float32, device=dev) for a in noise)
    x = x0 * grid.init_noise_sigma
    big_c = torch.cat([ctx_obj, ctx_bg, ctx_unc])
    # ll starts at 1.0 as in the reference: a constant that cancels in kappa
    ll = torch.ones((b, 2), dtype=torch.float32, device=dev)
    traces = {"kappa": [], "ll_obj": [], "ll_bg": []}
    for i in range(n):
        sigma = sigmas[i]
        dsigma = sigmas[i + 1] - sigmas[i]
        xin = x / torch.sqrt(sigma**2 + 1.0).to(dev)
        if not cfg.cond_dedup:
            xin = xin.repeat(3, 1, 1, 1)
        v_obj, v_bg, v_unc = mod.unet(xin, timesteps[i].to(dev), big_c).chunk(3)
        flat = lambda a: a.reshape(b, -1).contiguous()
        new_x, ll, kappa = sd_or_step(
            flat(v_obj), flat(v_bg), flat(v_unc), flat(x), flat(zs[i]), ll,
            sigma, dsigma, temperature=cfg.temperature, logp=cfg.logp,
            guidance=cfg.guidance_scale)
        x = new_x.reshape(shape)
        traces["kappa"].append(kappa)
        traces["ll_obj"].append(ll[:, 0])
        traces["ll_bg"].append(ll[:, 1])
    traces = {k: torch.stack(v) for k, v in traces.items()}
    traces.update(final_ll_obj=ll[:, 0], final_ll_bg=ll[:, 1])
    return x, traces


def make_sampler(mod: SDModules, method: str, cfg: SDPipelineConfig):
    """Sampler closure: (ctx_obj, ctx_bg, ctx_unc, *, generator, noise) ->
    (latents, traces)."""
    _check_method(method)

    def run(ctx_obj, ctx_bg, ctx_unc, *, generator=None, noise=None):
        return superdiff_sd_sample(mod, method, ctx_obj, ctx_bg, ctx_unc, cfg,
                                   generator=generator, noise=noise)

    return run


def prepare_contexts(mod: SDModules, method: str, obj: str, bg: str, batch_size: int):
    """(ctx_obj, ctx_bg, ctx_unc), each (batch_size, 77, hidden)."""
    _check_method(method)
    with torch.no_grad():
        return tuple(encode_prompts(mod, [p] * batch_size) for p in (obj, bg, ""))


def generate(
    mod: SDModules,
    method: str,
    obj: str,
    bg: str,
    *,
    seed: int = 1,
    batch_size: int = 6,
    cfg: Optional[SDPipelineConfig] = None,
    decode: bool = True,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> dict:
    """End-to-end generation: {"latents", "traces"[, "images" uint8 NHWC]}."""
    cfg = cfg or SDPipelineConfig()
    ctxs = prepare_contexts(mod, method, obj, bg, batch_size)
    gen = torch.Generator(device=mod.device).manual_seed(seed)
    latents, traces = make_sampler(mod, method, cfg)(*ctxs, generator=gen, noise=noise)
    out = {"latents": latents, "traces": traces}
    if decode:
        with torch.no_grad():
            out["images"] = decode_to_uint8(mod.vae, latents, mod.vae_scaling)
    return out
