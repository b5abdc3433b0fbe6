"""Runnable walkthroughs of the port: ``python -m
superdiff_tpu_torch.examples.superposition_2d``."""
