"""superdiff_tpu_torch — the PyTorch/CUDA port of ``superdiff_tpu`` for
NVIDIA Hopper (H100).

The JAX package ``superdiff_tpu`` is the numerical reference; this package
mirrors its structure and names:

  core/       schedules, Itô estimators, kappa policies, the joint sampler,
              the DSM loss
  models/     the CIFAR ScoreUNet and its ensembles, the toy MLP score net,
              the SD-1.x stack (UNet, CLIP text, VAE), InceptionV3, the
              protein score networks and the struct2seq conditioner
              (ProteinMPNN + ESM2), the weight and training-state carrier
              from Flax trees
  ops/        hand-written CUDA kernels for sm_90a, each beside its plain
              PyTorch version, built by nvcc at first use
  train/      training state, Adam + warmup + EMA step, checkpoints, the
              SE(3) DSM loss
  data/       image datasets with the reference's split DSL, PDB parsing
              and the protein training data
  eval/       FID / IS statistics, bits per dimension, CLIP / ImageReward,
              the protein metrics (structure, self-consistency, novelty,
              the structure-embedding map)
  utils/      metric logging, timing, image grids, the download policy
  pipelines/  end-to-end pipelines: sd, cifar (train, joint sampler, FID),
              protein (SE(3) composition)
  cli.py      the cifar, sd and protein commands

Importing the package touches no CUDA: kernels are compiled and loaded
inside the first call that launches them.
"""

__version__ = "0.1.0"

from . import core

__all__ = ["core", "__version__"]
