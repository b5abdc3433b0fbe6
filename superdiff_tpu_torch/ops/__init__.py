"""Hand-written Hopper kernels (``csrc/*.cu``), each with a plain PyTorch
version beside it and a launch counter on its wrapper."""
