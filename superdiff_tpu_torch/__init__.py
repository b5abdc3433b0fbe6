"""superdiff_tpu_torch — the PyTorch/CUDA port of ``superdiff_tpu`` for
NVIDIA Hopper (H100).

The JAX package ``superdiff_tpu`` is the numerical reference; this package
mirrors its structure and names:

  core/       schedules, Itô estimators, kappa policies, the joint sampler
  models/     the CIFAR ScoreUNet and its ensembles, the SD-1.x stack (UNet,
              CLIP text, VAE decoder), the weight carrier from Flax trees
  ops/        hand-written CUDA kernels for sm_90a, each beside its plain
              PyTorch version, built by nvcc at first use
  pipelines/  end-to-end pipelines: sd, cifar (joint sampler)

Importing the package touches no CUDA: kernels are compiled and loaded
inside the first call that launches them.
"""

__version__ = "0.1.0"

from . import core

__all__ = ["core", "__version__"]
