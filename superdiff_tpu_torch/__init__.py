"""superdiff_tpu_torch — the PyTorch/CUDA port of ``superdiff_tpu`` for
NVIDIA Hopper (H100).

The JAX package ``superdiff_tpu`` is the numerical reference; this package
mirrors its structure and names:

  core/       schedules, Itô estimators, kappa policies, the joint sampler,
              the DSM loss
  models/     the CIFAR ScoreUNet and its ensembles, the toy MLP score net,
              the SD-1.x stack (UNet, CLIP text, VAE), InceptionV3, the
              weight and training-state carrier from Flax trees
  ops/        hand-written CUDA kernels for sm_90a, each beside its plain
              PyTorch version, built by nvcc at first use
  train/      training state, Adam + warmup + EMA step, checkpoints
  data/       image datasets with the reference's split DSL
  eval/       FID / IS statistics and bits per dimension
  utils/      metric logging, timing, image grids
  pipelines/  end-to-end pipelines: sd, cifar (train, joint sampler, FID)

Importing the package touches no CUDA: kernels are compiled and loaded
inside the first call that launches them.
"""

__version__ = "0.1.0"

from . import core

__all__ = ["core", "__version__"]
