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

``or`` runs on static buffers (``_OrLoop``): each step reads its scalars
(t, sqrt(sigma^2 + 1), sigma, dsigma, a table built on the host in fp32 by
the ops the other methods' loop uses) and its noise through a device step
index. On the card (``capture=None`` or ``True``) the first run takes step
0 eagerly, captures the step in a CUDA graph and replays it for the other
steps, the port's counterpart of the JAX sampler's ``lax.scan``; the loop
is kept on the ``SDModules`` (``or_loop``, one at a time), so a later run
of the same shapes and config replays every step. ``capture=False`` calls
the same step eagerly, as the CPU does. The other methods run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import ito
from ..core import kappa as kp
from ..core.capture import StepLoop, want_capture
from ..core.schedules import SigmaGrid
from ..models.sd.clip import CLIPTextConfig, CLIPTextEncoder, Tokenizer
from ..models.from_jax import init_like_flax_
from ..models.sd import convert
from ..models.sd.unet import SDUNet, SDUNetConfig
from ..models.sd.vae import VAEConfig, VAEDecoder, decode_to_uint8
from ..ops.sd_fused_step import sd_or_step
from ..utils import profiling

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
    # the captured ``or`` loop of the last captured run (its static buffers
    # and CUDA graph), replayed by the next run of the same shapes and config
    or_loop: Optional["_OrLoop"] = dataclasses.field(default=None, init=False, repr=False,
                                                     compare=False)


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


def or_step_table(timesteps: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """(steps, 4) fp32 rows (t, sqrt(sigma^2 + 1), sigma, dsigma) of the
    sigma grid, each from the host scalars by the ops the sampler's loop
    applies to them, one step at a time, so every value has its bits."""
    rows = []
    for i in range(len(timesteps)):
        sigma = sigmas[i]
        dsigma = sigmas[i + 1] - sigmas[i]
        rows.append(torch.stack([timesteps[i], torch.sqrt(sigma**2 + 1.0), sigma, dsigma]))
    return torch.stack(rows)


class _OrLoop(StepLoop):
    """The ``or`` sampler on static buffers. ``step()`` takes the step index
    ``idx`` from device memory: its row of the scalar table and its unit
    normals, one UNet forward over the conditioning batch, ``sd_or_step``,
    then x, ll and the trace rows written in place and ``idx`` advanced, so
    the same launches serve every step, eagerly or replayed from a graph."""

    def __init__(self, mod: SDModules, cfg: SDPipelineConfig, table, x_init, zs, big_c):
        dev = x_init.device
        self.unet, self.cfg, self.table = mod.unet, dataclasses.replace(cfg), table
        # the inputs are copied: a kept loop loads the next run's over them
        self.x_init, self.zs, self.big_c = x_init.clone(), zs.clone(), big_c.clone()
        b, n = x_init.shape[0], table.shape[0]
        self.x = x_init.clone()
        self.ll = torch.ones((b, 2), dtype=torch.float32, device=dev)
        self.idx = torch.zeros((1,), dtype=torch.long, device=dev)
        self.kappa = torch.zeros((n, b), dtype=torch.float32, device=dev)
        self.lls = torch.zeros((n, b, 2), dtype=torch.float32, device=dev)
        profiling.count("loops_built")

    def fits(self, mod: SDModules, cfg: SDPipelineConfig, x_init, big_c) -> bool:
        """Whether a run of ``mod``'s UNet under ``cfg`` on these inputs can
        replay this loop: the same UNet, config, shapes, dtypes and device."""
        return (self.unet is mod.unet and self.cfg == cfg
                and all(a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
                        for a, b in ((self.x_init, x_init), (self.big_c, big_c))))

    def load(self, x_init, zs, big_c):
        """This run's inputs into the static buffers."""
        with profiling.span("load"):
            self.x_init.copy_(x_init)
            self.zs.copy_(zs)
            self.big_c.copy_(big_c)

    def reset(self):
        self.x.copy_(self.x_init)
        self.ll.fill_(1.0)
        self.idx.zero_()

    def step(self):
        cfg, x, b = self.cfg, self.x, self.x.shape[0]
        t, root, sigma, dsigma = self.table.index_select(0, self.idx)[0].unbind()
        eps = self.zs.index_select(0, self.idx)
        big_x = x if cfg.cond_dedup else x.repeat(3, 1, 1, 1)
        v_obj, v_bg, v_unc = self.unet(big_x / root, t, self.big_c).chunk(3)
        flat = lambda a: a.reshape(b, -1).contiguous()
        new_x, new_ll, kappa = sd_or_step(
            flat(v_obj), flat(v_bg), flat(v_unc), flat(x), flat(eps), self.ll, sigma, dsigma,
            temperature=cfg.temperature, logp=cfg.logp, guidance=cfg.guidance_scale)
        x.copy_(new_x.reshape(x.shape))
        self.ll.copy_(new_ll)
        self.kappa.index_copy_(0, self.idx, kappa[None])
        self.lls.index_copy_(0, self.idx, new_ll[None])
        self.idx += 1

    def run(self, capture: bool):
        """Every step from the start; returns (latents, traces), copies."""
        self.advance(self.table.shape[0], capture)
        ll = self.ll.clone()
        traces = {"kappa": self.kappa.clone(), "ll_obj": self.lls[..., 0].contiguous(),
                  "ll_bg": self.lls[..., 1].contiguous(), "final_ll_obj": ll[:, 0],
                  "final_ll_bg": ll[:, 1],
                  "final_ll_uncond": torch.ones_like(ll[:, 0])}
        return self.x.clone(), traces


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
    capture: Optional[bool] = None,
) -> Tuple[torch.Tensor, dict]:
    """Run one composed generation; returns (final latents NHWC fp32, traces).

    ``noise``: optional ``(x0, zs)`` or ``(x0, zs, probes)``: unit normals x0
    (B, H/8, W/8, 4) and zs (steps, B, H/8, W/8, 4), and the +/-1 probes of
    ``and_ode`` shaped like zs; what is missing is drawn from ``generator``.
    Traces: per-step ``kappa``, ``ll_obj``, ``ll_bg`` (steps, B) and the
    final log-likelihoods (``final_ll_uncond`` moves only under ``sd_*``),
    all fp32.
    ``capture`` (``or`` only): replay one step captured in a CUDA graph
    (``None``: on the card, not on the CPU; ``True`` on CPU tensors or
    another method raises); ``False`` runs the same step eagerly. The
    captured loop stays on ``mod`` (``mod.or_loop``) until a captured run of
    other shapes or config replaces it; ``mod.or_loop = None`` frees it.
    """
    with profiling.span("sample"):
        _check_method(method)
        dev = ctx_obj.device
        if method != "or" and capture:
            raise ValueError(f"capture=True: only 'or' runs as a captured step, not {method!r}")
        capture = method == "or" and want_capture(capture, dev, "superdiff_sd_sample")
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
        if method == "or":
            if capture and mod.or_loop is not None and mod.or_loop.fits(mod, cfg, x, big_c):
                mod.or_loop.load(x, zs, big_c)
                return mod.or_loop.run(capture)
            if capture:
                mod.or_loop = None  # its graph's memory goes before the next is captured
            loop = _OrLoop(mod, cfg, or_step_table(timesteps, sigmas).to(dev), x, zs, big_c)
            if capture:
                mod.or_loop = loop
            return loop.run(capture)
        # ll starts at 1.0 as in the reference: a constant that cancels in kappa
        ll_obj = ll_bg = ll_unc = torch.ones(b, dtype=torch.float32, device=dev)
        kappa = torch.full((b,), 0.5, dtype=torch.float32, device=dev)
        traces = {"kappa": [], "ll_obj": [], "ll_bg": []}
        for i in profiling.steps(range(n), "steps_eager"):
            sigma = sigmas[i]
            dsigma = sigmas[i + 1] - sigmas[i]
            t = timesteps[i].to(dev)
            root = torch.sqrt(sigma**2 + 1.0).to(dev)

            def vels(big_x):
                """One UNet forward over the conditioning batch."""
                return mod.unet(big_x / root, t, big_c)

            if method not in ("and_ode", "avg_ode"):
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
            else:  # and / avg / avg_ode
                v_obj, v_bg, v_unc = vels(x if cfg.cond_dedup else x.repeat(3, 1, 1, 1)).chunk(3)
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


def make_sampler(mod: SDModules, method: str, cfg: SDPipelineConfig, *,
                 capture: Optional[bool] = None):
    """Sampler closure: (ctx_obj, ctx_bg, ctx_unc, *, generator, noise) ->
    (latents, traces). ``capture`` as in :func:`superdiff_sd_sample`."""
    _check_method(method)

    def run(ctx_obj, ctx_bg, ctx_unc, *, generator=None, noise=None):
        return superdiff_sd_sample(mod, method, ctx_obj, ctx_bg, ctx_unc, cfg,
                                   generator=generator, noise=noise, capture=capture)

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
    with torch.no_grad(), profiling.span("encode"):
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
    capture: Optional[bool] = None,
) -> dict:
    """End-to-end generation: {"latents", "traces"[, "images" uint8 NHWC]};
    ``capture`` as in :func:`superdiff_sd_sample`. The call is a ``request``
    span around the ``encode``, ``sample`` and ``decode`` spans."""
    cfg = cfg or SDPipelineConfig()
    with profiling.span("request"):
        ctxs = prepare_contexts(mod, method, obj, bg, batch_size)
        gen = torch.Generator(device=mod.device).manual_seed(seed)
        latents, traces = make_sampler(mod, method, cfg, capture=capture)(
            *ctxs, generator=gen, noise=noise)
        out = {"latents": latents, "traces": traces}
        if decode:
            with torch.no_grad(), profiling.span("decode"):
                out["images"] = decode_to_uint8(mod.vae, latents, mod.vae_scaling)
    return out
