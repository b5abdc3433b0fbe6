"""Image datasets with the reference's split DSL (numpy host pipeline) and
the PDB-backed protein training data (``pdb``)."""

from . import pdb
from .datasets import (
    ImageDataset,
    PrefetchIterator,
    SplitSpec,
    get_image_inverse_scaler,
    get_image_scaler,
)

__all__ = ["pdb", "ImageDataset", "PrefetchIterator", "SplitSpec", "get_image_scaler",
           "get_image_inverse_scaler"]
