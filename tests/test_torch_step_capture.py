"""The samplers' capturable step loops against frozen copies of the
step-by-step loops they replaced, on the CPU, bit for bit.

SD ``or`` now runs on static buffers (``pipelines/sd.py::_OrLoop``): a
per-step scalar table, the UNet's timestep frequencies and upsampler taps as
module buffers, the noise and the scalars read through a device step index.
CIFAR SDE + OR likewise (``core/superpose.py::_SdeOrLoop``), with the unit
normals drawn before the loop and ``t`` broadcast from a tensor. Each must
give the same latents and traces, bit for bit (``torch.equal``), as the loop
it replaced: ``_frozen_or_loop`` and ``_frozen_sde_or_loop`` below are
those loops as they were, kept verbatim apart from the method branches they
no longer need. Capture itself needs the card (``chip_smoke.py`` holds the
captured runs to these eager ones there); asking for it on CPU tensors
raises. What a captured run does around the graph (step 0 eagerly, one
capture, the other steps replayed, the loop kept for the next run of the
same UNet, config and shapes) is checked here with a stand-in graph that
replays the recorded step on the CPU.
"""

import numpy as np
import pytest
import torch

from superdiff_tpu_torch.core import superpose as sp
from superdiff_tpu_torch.core.schedules import CosineVPSchedule, SigmaGrid, VPSchedule
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig
from superdiff_tpu_torch.models.sd.unet import SDUNetConfig
from superdiff_tpu_torch.models.sd.vae import VAEConfig
from superdiff_tpu_torch.ops.fused_step import fused_sde_step
from superdiff_tpu_torch.ops.sd_fused_step import sd_or_step
from superdiff_tpu_torch.pipelines import cifar, sd

torch.set_num_threads(1)

SD_STEPS, HW, BATCH = 3, 64, 2
CIFAR_STEPS = 4


# --- frozen copies of the loops before the capturable rewrite ---------------

def _frozen_embedding(t, dim, max_period=10_000.0):
    """``models/sd/unet.py::sd_timestep_embedding`` as it was: frequencies
    rebuilt and copied to ``t``'s device at every call."""
    half = dim // 2
    log_max = torch.log(torch.tensor(max_period, dtype=torch.float32))
    freqs = torch.exp(-log_max * torch.arange(half, dtype=torch.float32) / half)
    args = t.float().reshape(-1, 1) * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@torch.no_grad()
def _frozen_or_loop(mod, ctx_obj, ctx_bg, ctx_unc, cfg, noise):
    """``superdiff_sd_sample``'s step loop for ``or``, as it was."""
    dev = ctx_obj.device
    g = cfg.guidance_scale
    n = cfg.num_inference_steps
    grid = SigmaGrid.euler_discrete(n)
    timesteps, sigmas = grid.as_arrays(device="cpu")
    b = ctx_obj.shape[0]
    shape = (b, cfg.height // 8, cfg.width // 8, 4)
    x0, zs = noise
    x = x0 * grid.init_noise_sigma
    big_c = torch.cat([ctx_obj, ctx_bg, ctx_unc])
    ll_obj = ll_bg = torch.ones(b, dtype=torch.float32, device=dev)
    traces = {"kappa": [], "ll_obj": [], "ll_bg": []}
    for i in range(n):
        sigma = sigmas[i]
        dsigma = sigmas[i + 1] - sigmas[i]
        t = timesteps[i].to(dev)
        root = torch.sqrt(sigma**2 + 1.0).to(dev)
        big_x = x if cfg.cond_dedup else x.repeat(3, 1, 1, 1)
        v_obj, v_bg, v_unc = mod.unet(big_x / root, t, big_c).chunk(3)
        flat = lambda a: a.reshape(b, -1).contiguous()
        flat_x, ll, kappa = sd_or_step(
            flat(v_obj), flat(v_bg), flat(v_unc), flat(x), flat(zs[i]),
            torch.stack([ll_obj, ll_bg], dim=-1), sigma, dsigma,
            temperature=cfg.temperature, logp=cfg.logp, guidance=g)
        x = flat_x.reshape(shape)
        ll_obj, ll_bg = ll[:, 0], ll[:, 1]
        traces["kappa"].append(kappa)
        traces["ll_obj"].append(ll_obj)
        traces["ll_bg"].append(ll_bg)
    traces = {k: torch.stack(v) for k, v in traces.items()}
    traces.update(final_ll_obj=ll_obj, final_ll_bg=ll_bg)
    return x, traces


def _frozen_score_fn(models, labels):
    """``models/ensemble.py::make_stacked_score_fn`` as it was: ``t`` read on
    the host and written into a fill."""
    def score_fn(t, x):
        tb = torch.full((x.shape[0],) + (1,) * (x.ndim - 1), float(t), dtype=x.dtype,
                        device=x.device)
        return torch.stack([m(tb, x, labels) for m in models], dim=0)

    return score_fn


@torch.no_grad()
def _frozen_sde_or_loop(x_init, score_fn, schedule, cfg, n_models, noise=None,
                        generator=None):
    """``core/superpose.py::superpose`` for SDE + OR, as it was."""
    dev = x_init.device
    x = x_init
    logq = torch.zeros((x.shape[0], n_models), dtype=torch.float32, device=dev)
    dt = torch.tensor(cfg.dt, dtype=torch.float32)
    for i in range(cfg.n_steps):
        t = cfg.t_1 - torch.tensor(i, dtype=torch.float32) * dt
        if noise is not None:
            z = torch.as_tensor(noise[i], dtype=x.dtype, device=dev)
        else:
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=dev)
        x, logq = fused_sde_step(score_fn(t, x), x, z, logq, schedule.dlog_alpha_dt(t),
                                 schedule.beta(t), schedule.sigma(t), dt,
                                 temperature=cfg.or_temperature)
    return x, logq


# --- SD ``or`` ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_stack():
    mod = sd.build_sd_modules(0, unet_config=SDUNetConfig.tiny(),
                              text_config=CLIPTextConfig.tiny(), vae_config=VAEConfig.tiny(),
                              device="cpu", dtype=torch.float32)
    ctxs = sd.prepare_contexts(mod, "or", "a cat", "a dog", BATCH)
    return mod, ctxs


def _sd_noise(seed):
    rng = np.random.default_rng(seed)
    shape = (BATCH, HW // 8, HW // 8, 4)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((SD_STEPS,) + shape).astype(np.float32)))


def _assert_same_traces(got, ref):
    for key, val in ref.items():
        assert torch.equal(got[key], val), key


@pytest.mark.parametrize("dedup", [True, False])
def test_or_loop_equals_the_frozen_loop(sd_stack, dedup):
    mod, ctxs = sd_stack
    cfg = sd.SDPipelineConfig(num_inference_steps=SD_STEPS, height=HW, width=HW,
                              cond_dedup=dedup, temperature=1.3, logp=0.2)
    noise = _sd_noise(1)
    ref_x, ref_tr = _frozen_or_loop(mod, *ctxs, cfg, noise)
    x, tr = sd.superdiff_sd_sample(mod, "or", *ctxs, cfg, noise=noise, capture=False)
    assert torch.equal(x, ref_x)
    _assert_same_traces(tr, ref_tr)
    assert torch.equal(tr["final_ll_uncond"], torch.ones(BATCH))
    assert torch.isfinite(x).all() and ((tr["kappa"] >= 0) & (tr["kappa"] <= 1)).all()


def test_or_loop_draws_as_the_frozen_loop(sd_stack):
    """Without injected noise the sampler draws x0, then every step's
    normals in one call, from the generator, as before."""
    mod, ctxs = sd_stack
    cfg = sd.SDPipelineConfig(num_inference_steps=SD_STEPS, height=HW, width=HW)
    shape = (BATCH, HW // 8, HW // 8, 4)
    g = torch.Generator().manual_seed(4)
    noise = (torch.randn(shape, generator=g), torch.randn((SD_STEPS,) + shape, generator=g))
    ref_x, ref_tr = _frozen_or_loop(mod, *ctxs, cfg, noise)
    x, tr = sd.make_sampler(mod, "or", cfg)(*ctxs, generator=torch.Generator().manual_seed(4))
    assert torch.equal(x, ref_x)
    _assert_same_traces(tr, ref_tr)


def test_or_step_table_rows_are_the_loop_scalars():
    grid = SigmaGrid.euler_discrete(7)
    ts, sig = grid.as_arrays(device="cpu")
    table = sd.or_step_table(ts, sig)
    assert table.shape == (7, 4) and table.dtype == torch.float32
    for i in range(7):
        sigma, dsigma = sig[i], sig[i + 1] - sig[i]
        want = [ts[i], torch.sqrt(sigma**2 + 1.0), sigma, dsigma]
        assert all(torch.equal(table[i, j], w) for j, w in enumerate(want)), i


def test_unet_embedding_buffer_equals_the_frozen_embedding(sd_stack):
    """The module's frequency buffer gives the embedding the per-call
    frequencies gave, bit for bit."""
    mod, _ = sd_stack
    from superdiff_tpu_torch.models.sd.unet import sd_timestep_embedding

    ts = torch.tensor([999.0, 481.0, 20.25, 0.0])
    dim = mod.unet.config.block_out_channels[0]
    assert torch.equal(sd_timestep_embedding(ts, dim, freqs=mod.unet.temb_freqs),
                       _frozen_embedding(ts, dim))


def test_sd_capture_on_cpu_raises(sd_stack):
    mod, ctxs = sd_stack
    cfg = sd.SDPipelineConfig(num_inference_steps=1, height=HW, width=HW)
    with pytest.raises(ValueError, match="CUDA"):
        sd.superdiff_sd_sample(mod, "or", *ctxs, cfg, noise=_sd_noise(2), capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        sd.make_sampler(mod, "or", cfg, capture=True)(*ctxs, noise=_sd_noise(2))


@pytest.mark.parametrize("method", ["and", "avg", "sd_a"])
def test_sd_capture_of_an_eager_method_raises(sd_stack, method):
    mod, ctxs = sd_stack
    cfg = sd.SDPipelineConfig(num_inference_steps=1, height=HW, width=HW)
    with pytest.raises(ValueError, match="only 'or'"):
        sd.superdiff_sd_sample(mod, method, *ctxs, cfg, noise=_sd_noise(3), capture=True)


# --- the captured run's bookkeeping, with a stand-in for the graph -------------

class _StandInGraph:
    """What ``capture_step`` returns, on the CPU: ``replay()`` calls the
    step it recorded (capture itself needs the card)."""

    def __init__(self, step):
        self.step, self.replays = step, 0

    def replay(self):
        self.replays += 1
        self.step()


@pytest.fixture
def stand_in_capture(monkeypatch):
    """Capture "on" for CPU tensors: ``want_capture`` resolves None to True,
    ``capture_step`` runs the step once eagerly (the sampler's step 0, as on
    the card) and records it without running it. Returns the graphs made."""
    from superdiff_tpu_torch.core import capture

    made = []

    def capture_step(step):
        step()
        made.append(_StandInGraph(step))
        return made[-1]

    monkeypatch.setattr(capture, "capture_step", capture_step)
    for module in (sd, sp):
        monkeypatch.setattr(module, "want_capture", lambda c, dev, what: c is not False)
    return made


def test_captured_or_run_takes_step_0_eagerly_then_replays(sd_stack, stand_in_capture):
    """The first captured run: step 0 eagerly, one capture, the other steps
    replayed; the loop stays on the modules, so the next ``generate`` of
    the same shapes replays every step; each gives the frozen loop's
    answer."""
    mod, ctxs = sd_stack
    made = stand_in_capture
    mod.or_loop = None
    cfg = sd.SDPipelineConfig(num_inference_steps=SD_STEPS, height=HW, width=HW)
    for seed, replays in ((12, SD_STEPS - 1), (13, 2 * SD_STEPS - 1)):
        noise = _sd_noise(seed)
        ref_x, ref_tr = _frozen_or_loop(mod, *ctxs, cfg, noise)
        out = sd.generate(mod, "or", "a cat", "a dog", batch_size=BATCH, cfg=cfg,
                          decode=False, noise=noise)
        assert len(made) == 1 and made[0].replays == replays
        assert torch.equal(out["latents"], ref_x)
        _assert_same_traces(out["traces"], ref_tr)
    mod.or_loop = None


def test_kept_or_loop_replays_only_its_own_unet_and_config(sd_stack, stand_in_capture):
    """Another config, or another UNet behind the same kept loop, captures
    anew."""
    import copy
    import dataclasses

    mod, ctxs = sd_stack
    made = stand_in_capture
    mod.or_loop = None
    cfg = sd.SDPipelineConfig(num_inference_steps=SD_STEPS, height=HW, width=HW)
    noise = _sd_noise(14)
    sd.superdiff_sd_sample(mod, "or", *ctxs, cfg, noise=noise)
    hotter = dataclasses.replace(cfg, temperature=2.0)
    x, tr = sd.superdiff_sd_sample(mod, "or", *ctxs, hotter, noise=noise)
    assert len(made) == 2
    ref_x, ref_tr = _frozen_or_loop(mod, *ctxs, hotter, noise)
    assert torch.equal(x, ref_x)
    _assert_same_traces(tr, ref_tr)
    other = dataclasses.replace(mod, unet=copy.deepcopy(mod.unet))
    assert other.or_loop is None  # a copy of the modules does not take the loop
    other.or_loop = mod.or_loop
    sd.superdiff_sd_sample(other, "or", *ctxs, hotter, noise=noise)
    assert len(made) == 3 and other.or_loop.unet is other.unet
    mod.or_loop = None


# --- CIFAR SDE + OR -------------------------------------------------------------

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            compute_dtype="float32", image_size=16, eval_batch_size=4, conditioned=True)
LABELS = torch.tensor([0, 3, 7, 9])


def _nonzero_(model, seed):
    """Fan-in-scaled normal weights, 1 + 0.1 N norm scales, 0.1 N biases (a
    Flax-initialised net's zero output layers would leave logq at 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if p.ndim > 1:
                p.copy_(z / p[0].numel() ** 0.5)
            else:
                p.copy_(1.0 + 0.1 * z if name.endswith("weight") else 0.1 * z)
    return model


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def cifar_models(request):
    cfg = cifar.CifarConfig(**{**TINY, "compute_dtype": request.param})
    models = [_nonzero_(m, 20 + i) for i, m in
              enumerate(cifar.build_cifar_models([0, 1], cfg, "cpu"))]
    return cfg, models


def _cifar_noise(seed):
    rng = np.random.default_rng(seed)
    shape = (4, 16, 16, 3)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            rng.standard_normal((CIFAR_STEPS,) + shape).astype(np.float32))


def test_sde_or_loop_equals_the_frozen_loop(cifar_models):
    cfg, models = cifar_models
    x1, zs = _cifar_noise(5)
    sp_cfg = sp.SuperposeConfig(n_steps=CIFAR_STEPS)
    ref_x, ref_logq = _frozen_sde_or_loop(x1, _frozen_score_fn(models, LABELS), VPSchedule(),
                                          sp_cfg, 2, noise=zs)
    x0, logq = cifar.make_generator(models, cfg, n_steps=CIFAR_STEPS, labels=LABELS,
                                    capture=False)(noise=(x1, zs))
    assert torch.equal(x0, ref_x) and torch.equal(logq, ref_logq)
    assert torch.all(logq.max(-1).values == 0) and logq.min() < 0  # the OR weights moved


def test_sde_or_loop_draws_as_the_frozen_loop(cifar_models):
    """Without injected noise: x1 and then one draw a step from the same
    generator, in the same order, as the step-by-step loop drew them."""
    cfg, models = cifar_models
    g = torch.Generator().manual_seed(6)
    x1 = torch.randn((4, 16, 16, 3), generator=g)
    ref_x, ref_logq = _frozen_sde_or_loop(x1, _frozen_score_fn(models, LABELS), VPSchedule(),
                                          sp.SuperposeConfig(n_steps=CIFAR_STEPS), 2,
                                          generator=g)
    x0, logq = cifar.make_generator(models, cfg, n_steps=CIFAR_STEPS, labels=LABELS)(
        torch.Generator().manual_seed(6))
    assert torch.equal(x0, ref_x) and torch.equal(logq, ref_logq)


@pytest.mark.parametrize("schedule", [VPSchedule(), CosineVPSchedule()])
def test_sde_or_step_table_rows_are_the_loop_scalars(schedule):
    cfg = sp.SuperposeConfig(n_steps=9)
    table = sp.sde_or_step_table(schedule, cfg)
    assert table.shape == (9, 5) and table.dtype == torch.float32
    dt = torch.tensor(cfg.dt, dtype=torch.float32)
    for i in range(9):
        t = cfg.t_1 - torch.tensor(i, dtype=torch.float32) * dt
        want = [t, schedule.dlog_alpha_dt(t), schedule.beta(t), schedule.sigma(t), dt]
        assert all(torch.equal(table[i, j], w) for j, w in enumerate(want)), i


def test_score_fn_broadcasts_t_as_the_frozen_fill(cifar_models):
    """``t`` from a 0-d tensor gives the fill of ``float(t)``, in fp32 and
    in bf16 (an fp32 -> bf16 cast rounds as the fill of the double does)."""
    from superdiff_tpu_torch.models.ensemble import make_stacked_score_fn

    _, models = cifar_models
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 16, 16, 3))
                         .astype(np.float32))
    for t in (torch.tensor(0.995), torch.tensor(1e-3 + 1 / 3)):
        assert torch.equal(make_stacked_score_fn(models, LABELS)(t, x),
                           _frozen_score_fn(models, LABELS)(t, x))
    seen = []
    spy = lambda tb, xx, y: seen.append(tb) or xx
    for dtype in (torch.float32, torch.bfloat16):
        make_stacked_score_fn([spy], None)(torch.tensor(1 / 3), x.to(dtype))
        _frozen_score_fn([spy], None)(torch.tensor(1 / 3), x.to(dtype))
        assert seen[-2].dtype == dtype and torch.equal(seen[-2], seen[-1])


def test_cifar_capture_on_cpu_raises(cifar_models):
    cfg, models = cifar_models
    generate = cifar.make_generator(models, cfg, n_steps=1, labels=LABELS, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        generate(noise=_cifar_noise(8))


@pytest.mark.parametrize("mode,operator", [("sde", "avg"), ("ode", "or"), ("ode", "avg")])
def test_cifar_capture_of_an_eager_mode_raises(cifar_models, mode, operator):
    cfg, models = cifar_models
    generate = cifar.make_generator(models, cfg, mode=mode, operator=operator, n_steps=1,
                                    labels=LABELS, capture=True)
    with pytest.raises(ValueError, match="only sde / or"):
        generate(noise=_cifar_noise(9))


def test_two_calls_give_the_frozen_loops_answers(cifar_models):
    """One generator, two calls on other noise: each gives the frozen loop's
    answer (no state carries over from the first call)."""
    cfg, models = cifar_models
    generate = cifar.make_generator(models, cfg, n_steps=2, labels=LABELS, capture=False)
    sp_cfg = sp.SuperposeConfig(n_steps=2)
    for seed in (10, 11):
        x1, zs = _cifar_noise(seed)
        ref = _frozen_sde_or_loop(x1, _frozen_score_fn(models, LABELS), VPSchedule(), sp_cfg,
                                  2, noise=zs)
        got = generate(noise=(x1, zs))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_captured_sde_or_run_takes_step_0_eagerly_then_replays(cifar_models,
                                                               stand_in_capture):
    """The generator's first captured call: step 0 eagerly, one capture,
    the other steps replayed; its second call replays every step; both give
    the frozen loop's answers."""
    cfg, models = cifar_models
    made = stand_in_capture
    generate = cifar.make_generator(models, cfg, n_steps=CIFAR_STEPS, labels=LABELS)
    sp_cfg = sp.SuperposeConfig(n_steps=CIFAR_STEPS)
    for seed, replays in ((15, CIFAR_STEPS - 1), (16, 2 * CIFAR_STEPS - 1)):
        x1, zs = _cifar_noise(seed)
        ref = _frozen_sde_or_loop(x1, _frozen_score_fn(models, LABELS), VPSchedule(), sp_cfg,
                                  2, noise=zs)
        got = generate(noise=(x1, zs))
        assert len(made) == 1 and made[0].replays == replays
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
