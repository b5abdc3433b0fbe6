"""CIFAR joint SuperDiff sampler (port of the sampling half of
``superdiff_tpu/pipelines/cifar.py``).

``make_generator`` over N ``ScoreUNet`` checkpoints is what
``cli cifar --mode eval_joint_fid --chkpts a,b [--stoch]`` samples with: the
VP-SDE (or probability-flow ODE) joint reverse trajectory of
``core.superpose``, OR or averaged, at 200 steps by default. Training, FID
and Inception are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Sequence, Union

import torch

from ..core.schedules import VPSchedule
from ..core.superpose import SuperposeConfig, SuperposeSampler
from ..models.ensemble import make_stacked_score_fn
from ..models.from_jax import init_like_flax_
from ..models.unet import ScoreUNet


@dataclasses.dataclass
class CifarConfig:
    """Hyper-parameters of the reference base config
    (``cifar/configs/sm/cifar/vpsde.py``) that the sampler reads, with the
    JAX package's values; the training ones arrive with the training path."""

    image_size: int = 32
    num_channels: int = 3
    num_classes: int = 10
    conditioned: bool = False
    # model
    nf: int = 128
    ch_mult: Sequence[int] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = (16, 8)
    compute_dtype: str = "bfloat16"  # fp32 for parity runs
    # sampling
    t_1: float = 1.0
    eval_batch_size: int = 100
    n_sample_steps: int = 200  # dt = 5e-3 (eval_utils.py:75)

    def model(self) -> ScoreUNet:
        return ScoreUNet(
            nf=self.nf,
            ch_mult=tuple(self.ch_mult),
            num_res_blocks=self.num_res_blocks,
            attn_resolutions=tuple(self.attn_resolutions),
            num_classes=self.num_classes if self.conditioned else None,
            dtype=torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32,
            image_size=self.image_size,
            in_channels=self.num_channels,
        )


# Named configs of cifar/configs/sm/cifar/*.py as far as the sampler tells
# them apart: vpsdeB is vpsdeA, and vpsde_less_5 / vpsde_more_5 are vpsde,
# trained on other data; those names arrive with the training path.
CONFIGS = {
    "vpsde": CifarConfig,
    "vpsdeA": functools.partial(CifarConfig, conditioned=True),
}


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
    capture: Optional[bool] = None,
):
    """Batch sampler over the superposition of ``models``.

    Returns ``generate(generator=None, noise=None) -> (x0, logq)``: x0
    (eval_batch_size, H, W, C) fp32 NHWC, logq (eval_batch_size, N) fp32.
    ``noise``: optional ``(x1, zs)``, the initial unit normals (B, H, W, C)
    and the per-step draws (steps, B, H, W, C), unit normals for the SDE or
    Rademacher probes for the ODE; otherwise both are drawn from
    ``generator``. ``labels`` (B,) integers, for class-conditioned models.
    On CUDA tensors the SDE + OR step runs the ``fused_sde_step`` kernel,
    replayed from a CUDA graph unless ``capture=False`` (``superpose``'s
    ``capture``); the closure keeps its ``SuperposeSampler``, so a later
    call copies its inputs into the captured loop and replays every step.
    """
    models = list(models)
    dev = next(models[0].parameters()).device
    if labels is not None:
        labels = torch.as_tensor(labels, dtype=torch.long, device=dev)
    score_fn = make_stacked_score_fn(models, labels=labels)
    sp_cfg = SuperposeConfig(n_steps=n_steps or cfg.n_sample_steps, t_1=cfg.t_1,
                             mode=mode, operator=operator)
    shape = (cfg.eval_batch_size, cfg.image_size, cfg.image_size, cfg.num_channels)
    sampler = SuperposeSampler(score_fn, VPSchedule(), sp_cfg, len(models))

    def generate(generator: Optional[torch.Generator] = None, noise=None):
        if noise is None:
            x1, zs = torch.randn(shape, generator=generator, device=dev), None
        else:
            x1 = torch.as_tensor(noise[0], dtype=torch.float32, device=dev)
            zs = noise[1]
        x0, logq, _ = sampler(x1, noise=zs, generator=generator, capture=capture)
        return x0, logq

    return generate


def get_image_inverse_scaler():
    """[-1, 1] -> [0, 1] (the port's copy of ``data/datasets.py:369``, for
    the centred data the CIFAR configs use)."""
    return lambda x: (x + 1.0) / 2.0


def to_uint8(x0: torch.Tensor) -> torch.Tensor:
    """Samples in [-1, 1] -> uint8 images, as the eval loop stores them."""
    inverse = get_image_inverse_scaler()
    return torch.clamp(inverse(x0) * 255.0, 0, 255).to(torch.uint8)
