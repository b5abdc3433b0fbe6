"""Stable-Diffusion SuperDiff pipeline: two-prompt composition (port of
``superdiff_tpu/pipelines/sd.py``), all eleven methods:

  ``and`` / ``or`` / ``avg``        SDE composition (kappa AND / OR / fixed)
  ``and_ode`` / ``avg_ode``         probability-flow composition
  ``sd_ab`` ``sd_ba`` ``sd_ab_or``
  ``sd_ba_or`` ``sd_a`` ``sd_b``    single-prompt SD baselines

Sigma-space integration over the EulerDiscrete grid with classifier-free
guidance. Each step runs ONE UNet forward over the obj / bg / uncond
contexts (with conditioning dedup the latents enter once; the ``sd_*``
baselines evolve a second, unconditional trajectory and keep the tiled
forward). ``or`` ends in the fused epilogue: on CUDA the ``sd_or_step``
kernel, on the CPU its plain version. ``and_ode`` takes its two Hutchinson
divergences from one ``torch.func.jvp`` through that forward (every kernel's
tangent runs through its plain version). kappa and the running
log-likelihoods stay fp32 whatever the compute dtype.

Noise: the sampler takes injected draws (the initial latent, the per-step
unit normals and, for ``and_ode``, the per-step Rademacher probes), so tests
can hand in the JAX package's threefry draws; without them it draws from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import ito
from ..core import kappa as kp
from ..core.schedules import SigmaGrid
from ..models.sd.clip import CLIPTextConfig, CLIPTextEncoder, Tokenizer
from ..models.from_jax import init_like_flax_
from ..models.sd import convert
from ..models.sd.unet import SDUNet, SDUNetConfig
from ..models.sd.vae import VAEConfig, VAEDecoder, decode_to_uint8
from ..ops.sd_fused_step import sd_or_step

METHODS = (
    "and", "or", "avg", "and_ode", "avg_ode",
    "sd_ab", "sd_ba", "sd_ab_or", "sd_ba_or", "sd_a", "sd_b",
)


@dataclasses.dataclass
class SDPipelineConfig:
    num_inference_steps: int = 1000  # reference default
    guidance_scale: float = 7.5
    height: int = 512
    width: int = 512
    temperature: float = 1.0  # OR temperature
    logp: float = 0.0  # OR bias
    lift: float = 0.0  # AND lift bias
    kappa_fixed: float = 0.5  # avg methods
    # pass the shared latents ONCE per 3-conditioning forward (exact; see
    # the SDUNet docstring); the sd_* baselines keep the tiled forward
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
    weights_dir: Optional[str] = None,
    device="cuda",
    dtype=torch.bfloat16,
) -> SDModules:
    """Build the SD stack on ``device`` with random weights drawn from
    ``seed`` with the Flax initialisers' distributions; then, when
    ``weights_dir`` is given, load the HF diffusers safetensors found there
    (``models/sd/convert.py``; a module whose file is absent keeps its random
    init) and take the tokenizer from it."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ucfg = unet_config or SDUNetConfig()
    tcfg = text_config or CLIPTextConfig()
    vcfg = vae_config or VAEConfig()
    with torch.device(device):
        unet = SDUNet(ucfg, dtype=dtype)
        text = CLIPTextEncoder(tcfg, dtype=dtype)
        vae = VAEDecoder(vcfg, dtype=dtype)
    for m in (unet, text, vae):
        init_like_flax_(m, gen).eval().requires_grad_(False)
    if weights_dir:
        convert.load_sd_weights(
            weights_dir, unet, text, vae, clip_num_layers=tcfg.num_layers,
            unet_n_down=len(ucfg.block_out_channels),
            unet_layers_per_block=ucfg.layers_per_block,
            vae_n_levels=len(vcfg.channel_mults), vae_layers_per_block=vcfg.layers_per_block)
    return SDModules(unet=unet, text=text, tokenizer=Tokenizer(tcfg, hf_path=weights_dir),
                     vae=vae, vae_scaling=vcfg.scaling_factor, device=device)


def encode_prompts(mod: SDModules, prompts: list[str]) -> torch.Tensor:
    ids = torch.as_tensor(mod.tokenizer(prompts), dtype=torch.long, device=mod.device)
    return mod.text(ids)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")


def _sum_ev(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.float(), dim=tuple(range(1, x.ndim)))


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
    noise: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, dict]:
    """Run one composed generation; returns (final latents NHWC fp32, traces).

    ``noise``: optional ``(x0, zs)`` or ``(x0, zs, probes)``: unit normals x0
    (B, H/8, W/8, 4) and zs (steps, B, H/8, W/8, 4), and the +/-1 probes of
    ``and_ode`` shaped like zs; what is missing is drawn from ``generator``.
    Traces: per-step ``kappa``, ``ll_obj``, ``ll_bg`` (steps, B) and the
    final log-likelihoods (``final_ll_uncond`` moves only under ``sd_*``),
    all fp32.
    """
    _check_method(method)
    dev = ctx_obj.device
    g = cfg.guidance_scale
    n = cfg.num_inference_steps
    grid = SigmaGrid.euler_discrete(n)
    timesteps, sigmas = grid.as_arrays(device="cpu")
    b = ctx_obj.shape[0]
    shape = (b, cfg.height // 8, cfg.width // 8, 4)
    given = [a.to(dev, torch.float32) if isinstance(a, torch.Tensor)
             else torch.tensor(a, dtype=torch.float32, device=dev) for a in noise or ()]
    x0 = given[0] if given else torch.randn(shape, generator=generator, device=dev)
    zs = (given[1] if len(given) > 1
          else torch.randn((n,) + shape, generator=generator, device=dev))
    if method == "and_ode":
        probes = (given[2] if len(given) > 2
                  else ito.rademacher((n,) + shape, generator, device=dev))
    x = x_unc = x0 * grid.init_noise_sigma
    is_sd_baseline = method.startswith("sd_")
    big_c = torch.cat([ctx_obj, ctx_unc, ctx_unc] if is_sd_baseline
                      else [ctx_obj, ctx_bg, ctx_unc])
    # ll starts at 1.0 as in the reference: a constant that cancels in kappa
    ll_obj = ll_bg = ll_unc = torch.ones(b, dtype=torch.float32, device=dev)
    kappa = torch.full((b,), 0.5, dtype=torch.float32, device=dev)
    traces = {"kappa": [], "ll_obj": [], "ll_bg": []}
    for i in range(n):
        sigma = sigmas[i]
        dsigma = sigmas[i + 1] - sigmas[i]
        t = timesteps[i].to(dev)
        root = torch.sqrt(sigma**2 + 1.0).to(dev)

        def vels(big_x):
            """One UNet forward over the conditioning batch."""
            return mod.unet(big_x / root, t, big_c)

        if method not in ("or", "and_ode", "avg_ode"):
            noise_i = torch.sqrt(2.0 * abs(dsigma) * sigma) * zs[i]
        if is_sd_baseline:
            v_obj, v_unc, v_unc_only = vels(torch.cat([x, x, x_unc])).chunk(3)
            dx = 2.0 * dsigma * (v_unc + g * (v_obj - v_unc)) + noise_i
            new_x = x + dx
            # the unconditional trajectory sees the same noise
            x_unc = x_unc + 2.0 * dsigma * v_unc_only + noise_i
            ll_obj = ll_bg = (ll_obj - abs(dsigma) / sigma * _sum_ev(v_obj**2)
                              - _sum_ev(dx * v_obj) / sigma)
            ll_unc = (ll_unc - abs(dsigma) / sigma * _sum_ev(v_unc_only**2)
                      - _sum_ev(dx * v_unc_only) / sigma)
        elif method == "and_ode":
            probe = probes[i]
            if cfg.cond_dedup:
                # the uncond group's tangent is discarded, so the shared
                # probe through the dedup forward gives the same used values
                vals, tans = torch.func.jvp(vels, (x,), (probe,))
            else:
                vals, tans = torch.func.jvp(
                    vels, (x.repeat(3, 1, 1, 1),),
                    (torch.cat([probe, probe, torch.zeros_like(probe)]),))
            v_obj, v_bg, v_unc = vals.chunk(3)
            t_obj, t_bg, _ = tans.chunk(3)
            div_obj = -_sum_ev(probe * t_obj)  # the reference's sign
            div_bg = -_sum_ev(probe * t_bg)
            kappa = kp.kappa_and_ode(v_obj, v_bg, div_obj, div_bg, v_unc, sigma, dsigma,
                                     g, n, cfg.lift)
            vf = v_unc + g * ((v_bg - v_unc) + kappa[:, None, None, None] * (v_obj - v_bg))
            new_x = x + dsigma * vf
            dlls = ito.dlogq_ode_sigma_space(torch.stack([v_obj, v_bg]),
                                             torch.stack([div_obj, div_bg]), vf, sigma, dsigma)
            ll_obj, ll_bg = ll_obj + dlls[:, 0], ll_bg + dlls[:, 1]
        else:  # and / or / avg / avg_ode
            v_obj, v_bg, v_unc = vels(x if cfg.cond_dedup else x.repeat(3, 1, 1, 1)).chunk(3)
            if method == "or":
                flat = lambda a: a.reshape(b, -1).contiguous()
                flat_x, ll, kappa = sd_or_step(
                    flat(v_obj), flat(v_bg), flat(v_unc), flat(x), flat(zs[i]),
                    torch.stack([ll_obj, ll_bg], dim=-1), sigma, dsigma,
                    temperature=cfg.temperature, logp=cfg.logp, guidance=g)
                new_x = flat_x.reshape(shape)
                ll_obj, ll_bg = ll[:, 0], ll[:, 1]
            else:
                if method == "and":
                    dx_ind = 2.0 * dsigma * (v_unc + g * (v_bg - v_unc)) + noise_i
                    kappa = kp.kappa_and_sde(v_obj, v_bg, dx_ind, sigma, dsigma, g, n, cfg.lift)
                else:
                    kappa = torch.full((b,), cfg.kappa_fixed, dtype=torch.float32, device=dev)
                vf = v_unc + g * ((v_bg - v_unc) + kappa[:, None, None, None] * (v_obj - v_bg))
                if method == "avg_ode":
                    # noise-free step; no log-likelihood is tracked for it
                    new_x = x + dsigma * vf
                else:
                    dx = 2.0 * dsigma * vf + noise_i
                    new_x = x + dx
                    dlls = ito.dlogq_sde_sigma_space(torch.stack([v_obj, v_bg]), dx, sigma, dsigma)
                    ll_obj, ll_bg = ll_obj + dlls[:, 0], ll_bg + dlls[:, 1]
        x = new_x
        traces["kappa"].append(kappa)
        traces["ll_obj"].append(ll_obj)
        traces["ll_bg"].append(ll_bg)
    traces = {k: torch.stack(v) for k, v in traces.items()}
    traces.update(final_ll_obj=ll_obj, final_ll_bg=ll_bg, final_ll_uncond=ll_unc)
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
    """(ctx_obj, ctx_bg, ctx_unc), each (batch_size, 77, hidden); the
    ``sd_*`` baselines build their one prompt from both concepts."""
    _check_method(method)
    obj_prompt = {
        "sd_ab": f"{obj} that looks like {bg}", "sd_ab_or": f"{obj} or {bg}",
        "sd_ba": f"{bg} that looks like {obj}", "sd_ba_or": f"{bg} or {obj}",
        "sd_b": bg,
    }.get(method, obj)
    with torch.no_grad():
        return tuple(encode_prompts(mod, [p] * batch_size) for p in (obj_prompt, bg, ""))


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
    noise: Optional[Tuple[torch.Tensor, ...]] = None,
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
