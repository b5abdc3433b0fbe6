"""Score networks: the CIFAR ScoreUNet (with GroupNorm32) and its ensembles,
the SD-1.x stack, and the weight carrier from Flax parameter trees."""
