"""CIFAR experiment entry points: train / eval_fid / eval_joint_fid / fid_stats
(port of ``superdiff_tpu/pipelines/cifar.py``; ``cifar/main.py`` +
``cifar/run_lib.py``).

* ``train``: DSM training of one ``ScoreUNet`` with Adam, warmup, EMA and
  checkpoints every ``save_every`` steps, resuming from the latest one;
  data-parallel over the ranks of a process group, as JAX's mesh step.
* ``make_generator``: the joint SuperDiff sampler over N checkpoints, the
  VP-SDE (or probability-flow ODE) reverse trajectory of
  ``core.superpose``, OR or averaged; SDE + OR replays one captured step
  with the ``fused_sde_step`` kernel on the card.
* ``evaluate_joint_fid`` / ``evaluate_fid`` / ``fid_stats``: samples to
  ``samples_{i}.npz``, InceptionV3 pool3 features, FID against a
  ``{dataset}_{split}_stats.npz``, ``report.json``: the JAX package's files.

Every entry point runs on the card unless ``device="cpu"`` is passed. The
random streams are ``torch.Generator``s seeded from ``cfg.seed``; JAX's
threefry keys cannot be reproduced, so runs of the two packages from the
same seed draw different numbers (the tests inject JAX's draws).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..core import ito
from ..core.dsm import make_dsm_loss
from ..core.schedules import VPSchedule
from ..core.superpose import SuperposeConfig, SuperposeSampler
from ..data.datasets import ImageDataset, PrefetchIterator, get_image_inverse_scaler
from ..eval import fid as fid_lib
from ..models.ensemble import make_stacked_score_fn
from ..models.from_jax import init_like_flax_
from ..models.unet import ScoreUNet
from ..parallel.distributed import is_coordinator
from ..parallel.mesh import data_sharding, make_mesh
from ..train import checkpoints as ckpt_lib
from ..train import init_train_state, make_optimizer, make_train_step
from ..utils import profiling
from ..utils.images import stack_imgs
from ..utils.logging import MetricLogger


@dataclasses.dataclass
class CifarConfig:
    """Hyper-parameters of the reference base config
    (``cifar/configs/sm/cifar/vpsde.py``), with the JAX package's values."""

    seed: int = 1
    dataset: str = "cifar10"
    train_split: str = "train"
    image_size: int = 32
    num_channels: int = 3
    num_classes: int = 10
    conditioned: bool = False
    # model
    nf: int = 128
    ch_mult: Sequence[int] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = (16, 8)
    dropout: float = 0.1
    ema_rate: float = 0.9999
    compute_dtype: str = "bfloat16"  # fp32 for parity runs
    # training
    batch_size: int = 128
    n_iters: int = 500_000
    save_every: int = 5_000
    eval_every: int = 10_000
    log_every: int = 50
    lr: float = 2e-4
    warmup: int = 5_000
    grad_clip: float = 1.0
    t_0: float = 0.0
    t_1: float = 1.0
    # eval
    eval_batch_size: int = 100
    num_samples: int = 50_000
    n_sample_steps: int = 200  # dt = 5e-3 (eval_utils.py:75)
    n_train_sample_steps: int = 100  # dt = 1e-2 (eval_utils.py:56)

    def model(self) -> ScoreUNet:
        return ScoreUNet(
            nf=self.nf,
            ch_mult=tuple(self.ch_mult),
            num_res_blocks=self.num_res_blocks,
            attn_resolutions=tuple(self.attn_resolutions),
            dropout=self.dropout,
            num_classes=self.num_classes if self.conditioned else None,
            dtype=torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32,
            image_size=self.image_size,
            in_channels=self.num_channels,
        )


# Named configs mirroring cifar/configs/sm/cifar/*.py
def config_vpsde(**kw) -> CifarConfig:
    return CifarConfig(**kw)


def config_vpsde_a(**kw) -> CifarConfig:
    return CifarConfig(conditioned=True, train_split="train[:50%]", **kw)


def config_vpsde_b(**kw) -> CifarConfig:
    return CifarConfig(conditioned=True, train_split="train[50%:]", **kw)


def config_vpsde_less_5(**kw) -> CifarConfig:
    return CifarConfig(train_split="train<5", **kw)


def config_vpsde_more_5(**kw) -> CifarConfig:
    return CifarConfig(train_split="train>5", **kw)


CONFIGS = {
    "vpsde": config_vpsde,
    "vpsdeA": config_vpsde_a,
    "vpsdeB": config_vpsde_b,
    "vpsde_less_5": config_vpsde_less_5,
    "vpsde_more_5": config_vpsde_more_5,
}


def _seed(*ints: int) -> int:
    """A 63-bit seed for a torch.Generator from (cfg.seed, step, ...): the
    counterpart of JAX's ``fold_in``."""
    return int(np.random.SeedSequence(list(ints)).generate_state(1, np.uint64)[0] >> 1)


def _labels(cfg: CifarConfig, dev) -> Optional[torch.Tensor]:
    """0-9 tiled over the eval batch for a class-conditioned config."""
    if not cfg.conditioned:
        return None
    b = cfg.eval_batch_size
    return torch.arange(10, device=dev).repeat(b // 10 + 1)[:b]


def _apply_fn(model: ScoreUNet):
    def apply_fn(t, x, y, generator=None):
        return model(t, x, y, generator=generator)

    return apply_fn


def init_state(cfg: CifarConfig, workdir: str, *, device="cuda"):
    """Init or restore (preemption-safe) the training state.

    A fresh state draws the parameters with the Flax initialisers'
    distributions from a ``torch.Generator`` seeded with ``cfg.seed``,
    which then goes on as the state's generator (eps and dropout masks).
    Returns (model, state, optimizer spec, checkpoint manager)."""
    dev = torch.device(device)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    with torch.device(dev):
        model = cfg.model()
    init_like_flax_(model, generator)
    opt = make_optimizer(cfg.lr, cfg.warmup, grad_clip=cfg.grad_clip)
    state = init_train_state(generator, model, opt, ema_rate=cfg.ema_rate)
    mgr = ckpt_lib.make_manager(workdir)
    restored = ckpt_lib.restore_latest(mgr, state)
    if restored is not None:
        state = restored
    return model, state, opt, mgr


def build_cifar_models(
    weights: Sequence[Union[int, Mapping[str, torch.Tensor]]],
    cfg: CifarConfig,
    device="cuda",
) -> list[ScoreUNet]:
    """One ``ScoreUNet`` of ``cfg`` per entry of ``weights``, in eval mode
    on ``device`` with fp32 parameters: an int seeds a draw with the Flax
    initialisers' distributions (``init_like_flax_``: the zero-init output
    layers make such a net's scores exactly 0), a state_dict is loaded as
    it is (e.g. ``state_dict_from_flax`` of a carried checkpoint)."""
    device = torch.device(device)
    models = []
    for w in weights:
        with torch.device(device):
            net = cfg.model()
        if isinstance(w, Mapping):
            net.load_state_dict(w, strict=True)
        else:
            init_like_flax_(net, torch.Generator(device=device).manual_seed(int(w)))
        models.append(net.eval().requires_grad_(False))
    return models


def make_generator(
    models: Sequence[ScoreUNet],
    cfg: CifarConfig,
    *,
    mode: str = "sde",
    operator: str = "or",
    n_steps: Optional[int] = None,
    labels=None,
    score_mode: str = "unroll",
    mesh=None,
    capture: Optional[bool] = None,
):
    """Batch sampler over the superposition of ``models``.

    Returns ``generate(generator=None, noise=None) -> (x0, logq)``: x0
    (eval_batch_size, H, W, C) fp32 NHWC, logq (eval_batch_size, N) fp32.
    ``noise``: optional ``(x1, zs)``, the initial unit normals (B, H, W, C)
    and the per-step draws (steps, B, H, W, C), unit normals for the SDE or
    Rademacher probes for the ODE; otherwise both are drawn from
    ``generator``. ``labels`` (B,) integers, for class-conditioned models.
    ``score_mode``: ``"unroll"`` (N forwards) or ``"vmap"`` (one shared
    body over the stacked parameters), ``models.ensemble``'s ``mode``.
    On CUDA tensors the SDE + OR step runs the ``fused_sde_step`` kernel,
    replayed from a CUDA graph unless ``capture=False`` (``superpose``'s
    ``capture``); the closure keeps its ``SuperposeSampler``, so a later
    call copies its inputs into the captured loop and replays every step.
    Each call is a ``request`` span.

    ``mesh`` (a ``parallel.mesh.Mesh``): the batch is split over the data
    axes and the models over ``model`` (``make_stacked_score_fn``). Each
    rank samples its rows, and the rows are all-gathered at the end, so
    every rank returns the whole batch. Without ``noise`` every rank draws
    the whole batch's noise, in the order one process draws it, and takes
    its rows: a mesh run draws what a one-rank run does. A ``model`` axis
    above 1 puts an all-gather in every step, and the step then runs
    eagerly (``capture=True`` raises); on a data axis alone the step holds
    no collective and is captured as on one rank.
    """
    models = list(models)
    dev = next(models[0].parameters()).device
    if labels is not None:
        labels = torch.as_tensor(labels, dtype=torch.long, device=dev)
    shape = (cfg.eval_batch_size, cfg.image_size, cfg.image_size, cfg.num_channels)
    sp_cfg = SuperposeConfig(n_steps=n_steps or cfg.n_sample_steps, t_1=cfg.t_1,
                             mode=mode, operator=operator)
    split = False  # the batch over the data axes
    if mesh is not None:
        from ..parallel.mesh import dp_axes, shard_batch

        if mesh.shape.get("model", 1) > 1:
            if capture:
                raise ValueError("capture=True: a model axis puts an all-gather in the step")
            capture = False
        split = mesh.size(dp_axes(mesh)) > 1
        if split and labels is not None:
            labels = shard_batch(labels, mesh)
    score_fn = make_stacked_score_fn(models, labels=labels, mode=score_mode, mesh=mesh)
    sampler = SuperposeSampler(score_fn, VPSchedule(), sp_cfg, len(models))

    def generate(generator: Optional[torch.Generator] = None, noise=None):
        with profiling.span("request"):
            if noise is None and split:
                noise = _draw_noise(generator, shape, sp_cfg, dev)
            if noise is None:
                x1, zs = torch.randn(shape, generator=generator, device=dev), None
            else:
                x1 = torch.as_tensor(noise[0], dtype=torch.float32, device=dev)
                zs = noise[1]
            if split:
                x1 = shard_batch(x1, mesh)
                zs = [shard_batch(torch.as_tensor(z, device=dev), mesh) for z in zs]
            x0, logq, _ = sampler(x1, noise=zs, generator=generator, capture=capture)
            if split:
                x0 = mesh.all_gather(x0, dp_axes(mesh), dim=0)
                logq = mesh.all_gather(logq, dp_axes(mesh), dim=0)
        return x0, logq

    return generate


def _draw_noise(generator, shape, sp_cfg: SuperposeConfig, dev):
    """The whole batch's (x1, per-step draws), in the order and of the kind
    ``generate`` and ``SuperposeSampler`` draw them on one rank."""
    x1 = torch.randn(shape, generator=generator, device=dev)
    if sp_cfg.mode == "ode":
        zs = [ito.rademacher(shape, generator, torch.float32, dev) for _ in range(sp_cfg.n_steps)]
    else:
        zs = [torch.randn(shape, generator=generator, device=dev) for _ in range(sp_cfg.n_steps)]
    return x1, zs


def train(
    cfg: CifarConfig,
    workdir: str,
    n_iters: Optional[int] = None,
    *,
    eval_artifacts: bool = False,
    estimate_bpd: bool = False,
    device="cuda",
):
    """Training mode (``run_lib.py:55-126``): DSM + EMA + periodic ckpt/eval.

    The JAX loop's rules: the state resumes from the latest checkpoint in
    ``workdir`` and runs its steps ``state.step .. n_iters`` (so a state
    ends at ``n_iters + 1``); the data iterator starts afresh from
    ``cfg.seed``, as in JAX; ``metrics.jsonl`` gets the loss when ``step %
    log_every == 0``; a checkpoint with the step as its id when ``step %
    save_every == 0``. ``eval_artifacts`` writes a 64-sample grid every
    ``eval_every`` steps (the averaged SDE of ``n_train_sample_steps`` over
    the current parameters, ``run_lib.py:110-125``) to
    ``artifacts_{step}.npz``; ``estimate_bpd`` also logs bits/dim of the
    current batch (50 RK4 steps, ``run_lib.py:121-126``). Returns the state.

    Under a process group (``parallel.distributed.initialize``) the step is
    data-parallel over ``make_mesh(model=1)``, as in JAX: every rank reads
    the same global batch and trains on its slice (``make_train_step``'s
    ``mesh``), its times, noise and dropout masks the global batch's, and
    only rank 0 writes metrics, checkpoints and artifacts.
    """
    os.makedirs(workdir, exist_ok=True)
    dev = torch.device(device)
    model, state, opt, mgr = init_state(cfg, workdir, device=dev)
    schedule = VPSchedule()
    mesh = make_mesh(model=1)
    shards = data_sharding(mesh)
    model.shard_dropout(*shards)
    loss_fn = make_dsm_loss(_apply_fn(model), schedule, t_0=cfg.t_0, t_1=cfg.t_1,
                            num_shards=shards[0], shard_index=shards[1])
    step_fn = make_train_step(opt, loss_fn, mesh=mesh)
    coordinator = is_coordinator()
    ds = ImageDataset(cfg.dataset, cfg.train_split, seed=cfg.seed, image_size=cfg.image_size)
    it = PrefetchIterator(ds.batches(cfg.batch_size))
    logger = MetricLogger(os.path.join(workdir, "metrics.jsonl"))
    total = n_iters or cfg.n_iters
    t_start = time.time()
    try:
        for step in range(state.step, total + 1):
            host_batch = next(it)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
            state, loss = step_fn(state, batch)
            if coordinator and step % cfg.log_every == 0:
                logger.log(step=step, loss=float(loss),
                           steps_per_sec=cfg.log_every / max(time.time() - t_start, 1e-9))
                t_start = time.time()
            if coordinator and step % cfg.save_every == 0:
                # id = the step (interval-relative ids would collide across
                # runs with different save_every)
                ckpt_lib.save(mgr, step, state)
            if coordinator and eval_artifacts and step % cfg.eval_every == 0:
                _train_artifacts(cfg, workdir, state, batch, step, estimate_bpd, logger, dev)
    finally:
        it.close()
    return state


def _train_artifacts(cfg, workdir, state, batch, step, estimate_bpd, logger, dev):
    """The sample grid (and bits/dim) of the current parameters."""
    net = build_cifar_models([state.model.state_dict()], cfg, dev)[0]
    generate = make_generator([net], cfg, mode="sde", operator="avg",
                              n_steps=cfg.n_train_sample_steps, labels=_labels(cfg, dev))
    x0, _ = generate(torch.Generator(device=dev).manual_seed(_seed(cfg.seed, step)))
    side = min(8, int(np.sqrt(x0.shape[0])))
    grid = stack_imgs(get_image_inverse_scaler()(x0).cpu().numpy(), side, side)
    np.savez_compressed(os.path.join(workdir, f"artifacts_{step}.npz"), grid=grid)
    logger.log(step=step, nfe=cfg.n_train_sample_steps, artifact=f"artifacts_{step}.npz")
    if estimate_bpd:
        from ..eval.bpd import make_bpd_estimator

        def score_apply(t, xx):
            return net(t.expand(xx.shape[0], 1, 1, 1), xx, None)

        bpd_val, _ = make_bpd_estimator(score_apply, VPSchedule(), n_steps=50)(
            batch["image"], generator=torch.Generator(device=dev).manual_seed(
                _seed(cfg.seed, step + 1)))
        logger.log(step=step, bpd=float(bpd_val))


def _generate_and_collect(generate, cfg: CifarConfig, generator, sample_dir, feature_fn):
    num_batches = math.ceil(cfg.num_samples / cfg.eval_batch_size)
    all_feats = []
    for batch_id in range(num_batches):
        x0, _ = generate(generator)
        imgs = to_uint8(x0).cpu().numpy()
        np.savez_compressed(os.path.join(sample_dir, f"samples_{batch_id}.npz"), samples=imgs)
        if feature_fn is not None:
            all_feats.append(feature_fn(imgs))
    return np.concatenate(all_feats, axis=0)[: cfg.num_samples] if all_feats else None


def evaluate_joint_fid(
    cfg: CifarConfig,
    workdir: str,
    checkpoint_dirs: Sequence[str],
    *,
    stoch: bool = True,
    operator: str = "or",
    eval_folder: str = "eval",
    stats_path: Optional[str] = None,
    inception_weights: Optional[str] = None,
    feature_fn=None,
    device="cuda",
):
    """SuperDiff joint FID over N checkpoints (``run_lib.py:201-278``).

    Each run directory's latest checkpoint gives its EMA parameters; the
    joint sampler (``make_generator``: SDE if ``stoch`` else ODE, under
    ``operator``) draws ``num_samples`` images in batches of
    ``eval_batch_size``, each batch saved as uint8 NHWC ``samples`` in
    ``{workdir}/{eval_folder}/samples[_stoch]/samples_{i}.npz``; their
    features (``feature_fn(uint8_images) -> (N, D)``, by default InceptionV3
    pool3 from ``inception_weights``, a local file) against the pool3
    statistics at ``stats_path`` give the FID, written to
    ``{workdir}/{eval_folder}/report.json`` (empty without features or
    stats). Returns the report.
    """
    dev = torch.device(device)
    weights = []
    for cdir in checkpoint_dirs:
        _, state, _, _ = init_state(cfg, cdir, device=dev)
        weights.append(dict(state.params_ema))
    models = build_cifar_models(weights, cfg, dev)
    generate = make_generator(models, cfg, mode="sde" if stoch else "ode", operator=operator,
                              labels=_labels(cfg, dev))
    sample_dir = os.path.join(workdir, eval_folder, "samples_stoch" if stoch else "samples")
    os.makedirs(sample_dir, exist_ok=True)
    if feature_fn is None:
        feature_fn = fid_lib.get_inception_feature_fn(inception_weights, device=dev)
    feats = _generate_and_collect(generate, cfg, torch.Generator(device=dev).manual_seed(cfg.seed),
                                  sample_dir, feature_fn)
    report = {}
    if feats is not None and stats_path:
        ref = fid_lib.load_dataset_stats(stats_path)
        report["fid"] = fid_lib.fid_from_features(ref, feats)
    with open(os.path.join(workdir, eval_folder, "report.json"), "w") as f:
        json.dump(report, f)
    return report


def evaluate_fid(cfg: CifarConfig, workdir: str, *, stoch: bool = True, **kw):
    """Single-model FID via the averaged field of one model (``run_lib.py:129-198``)."""
    return evaluate_joint_fid(cfg, workdir, [workdir], stoch=stoch, operator="avg", **kw)


def fid_stats(
    cfg: CifarConfig,
    workdir: str,
    *,
    fid_folder: str = "assets/stats",
    inception_weights: Optional[str] = None,
    device="cuda",
):
    """Precompute dataset pool3 statistics (``run_lib.py:281-324``): one npz
    per split, ``pool_3`` the features of every full eval batch, in the
    reference's ``{dataset}_{split}_stats.npz`` format. Returns the folder."""
    feature_fn = fid_lib.get_inception_feature_fn(inception_weights, device=device)
    if feature_fn is None:
        raise RuntimeError("Inception weights unavailable; pass inception_weights=<local "
                           ".npz or .h5>")
    out_dir = os.path.join(workdir, fid_folder)
    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "test"):
        ds = ImageDataset(cfg.dataset, split, seed=cfg.seed, image_size=cfg.image_size)
        feats = []
        for batch in ds.batches(
            cfg.eval_batch_size, uniform_dequantization=False,
            random_flip=False, scale_to_pm1=False, loop=False,
        ):
            imgs = (batch["image"] * 255).astype(np.uint8)
            feats.append(feature_fn(imgs))
        path = os.path.join(out_dir, f"{cfg.dataset.lower()}_{split}_stats.npz")
        np.savez_compressed(path, pool_3=np.concatenate(feats, axis=0))
    return out_dir


def to_uint8(x0: torch.Tensor) -> torch.Tensor:
    """Samples in [-1, 1] -> uint8 images, as the eval loop stores them."""
    inverse = get_image_inverse_scaler()
    return torch.clamp(inverse(x0) * 255.0, 0, 255).to(torch.uint8)
